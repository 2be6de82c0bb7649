"""K1's launch plan (ops/cuda_fused.k1_plan) at the shapes the main
paths give it.

The plan is plain Python, so its invariants hold here without a card:
every (pair, plane, row) of a launch lies in exactly one CTA, a cluster
has at most 16 CTAs, a unit spans several clusters only where all of
the launch's clusters fit the card at once, a CTA asks for no more than
the card's 232,448 bytes of shared memory, and the plan is a pure
function of the shape.  (The labels a lane and the warps a CTA follow
from L and the plan in the kernel, csrc/fused_wavefront.cuh.)  This
file imports neither jax nor mgm_tpu.
"""
import pytest

from mgm_tpu_torch.ops import cuda_fused, fused

H100_SMS = 132  # an H100 SXM's streaming multiprocessors

# (rows, labels, (ndir, TSGM), pairs): the fused rows of
# scripts/bench_matrix.py and the cells of PERF.md, at the K1 launches
# their solves make (LR: two sides a pair)
SHAPES = {
    "cfg1": (500, 151, (4, 2), 1),
    "cfg1_tsgm4": (500, 151, (4, 4), 1),
    "full_16dir": (500, 151, (16, 2), 1),
    "cfg2": (500, 151, (8, 3), 1),
    "cfg1_mM": (500, 151, (4, 2), 1),
    "cfg1_iter3": (500, 167, (4, 2), 1),
    "cfg3_b8": (271, 42, (8, 3), 8),
    "cfg3_b32": (271, 42, (8, 3), 32),
    "cfg3_scene tile": (681, 42, (8, 3), 5),
    "3000x4000 L=256": (3000, 256, (4, 2), 1),
    "L=1024": (64, 1024, (8, 4), 2),
    "one CTA's counters exceed its shared memory": (60000, 42, (8, 3), 32),
}


def _plane_counts(ndir, mgm, nsides=2):
    """Mp of each K1 launch of a solve's fused groups."""
    groups = fused.split_passes(ndir, mgm)[0]
    return [len(kw["planes"]) for g in groups
            for kw in fused.group_launches(
                g, ((0, 0, 1),) * nsides, R=8, mgm=mgm, kappa=0.0,
                fold=False)]


def _cta_rows(plan, R, cta):
    """The image rows CTA `cta` of a unit holds, in local order, as the
    kernel maps them (fused_wavefront_cluster): bands of plan.band rows
    dealt to the unit's cluster * ncl CTAs in turn."""
    nc = plan.cluster * plan.ncl
    rows = [((j // plan.band) * nc + cta) * plan.band + j % plan.band
            for j in range(plan.rows)]
    return [r for r in rows if r < R]


def _check_plan(plan, R, Mp, npair, sms):
    assert 1 <= plan.cluster <= cuda_fused.MAX_CLUSTER and plan.ncl >= 1
    nc = plan.cluster * plan.ncl
    if plan.ncl > 1:
        # a unit's clusters wait on one another: every cluster of the
        # launch must fit the card at once (here: one CTA an SM)
        assert Mp * npair * nc <= sms
    # at least two ints a local row (its count, its row-table entry)
    assert 8 * plan.rows <= plan.smem <= cuda_fused.SMEM_PER_CTA
    bands = -(-R // plan.band)
    assert bands >= nc and plan.rows == -(-bands // nc) * plan.band
    # every row of a unit in exactly one CTA, every CTA with a row (the
    # grid is (cluster * ncl, Mp, npair) and the rows map alike in each
    # (pair, plane), so one unit's rows are checked)
    seen = []
    for cta in range(nc):
        mine = _cta_rows(plan, R, cta)
        assert mine, f"CTA {cta} holds no row"
        assert mine == sorted(mine)  # local rows rise with the image's
        seen += mine
    assert sorted(seen) == list(range(R))


@pytest.mark.parametrize("name", SHAPES)
def test_k1_plan_invariants(name):
    R, L, (ndir, mgm), npair = SHAPES[name]
    for Mp in _plane_counts(ndir, mgm):
        plan = cuda_fused.k1_plan(R, L, Mp, npair, H100_SMS)
        _check_plan(plan, R, Mp, npair, H100_SMS)
        # a pure function of the shape
        assert cuda_fused.k1_plan(R, L, Mp, npair, H100_SMS) == plan
        cuda_fused.k1_plan(7, 3, 1, 1, H100_SMS)
        assert cuda_fused.k1_plan(R, L, Mp, npair, H100_SMS) == plan


@pytest.mark.parametrize("sms", [1, 8, 33, 64, 132])
@pytest.mark.parametrize("R,Mp,npair", [(500, 4, 1), (500, 2, 1),
                                        (271, 4, 8), (681, 4, 5), (40, 1, 1),
                                        (7, 3, 1)])
def test_k1_plan_on_other_cards(sms, R, Mp, npair):
    """The invariants hold for any SM count: one cluster a unit on small
    cards, several only where all of them fit."""
    _check_plan(cuda_fused.k1_plan(R, 151, Mp, npair, sms), R, Mp, npair,
                sms)


@pytest.mark.parametrize("R,L,Mp,npair", [
    (0, 151, 4, 1), (500, 0, 4, 1), (500, 1025, 4, 1), (500, 151, 9, 1),
    (500, 151, 4, 65536), (16 * 29056 + 1, 151, 1, 1)])
def test_k1_plan_refuses_shapes_beyond_the_kernel(R, L, Mp, npair):
    with pytest.raises(ValueError, match="k1_plan"):
        cuda_fused.k1_plan(R, L, Mp, npair, H100_SMS)


@pytest.mark.parametrize("held", [0, 1, 7, 8, 14, 15, 30])
@pytest.mark.parametrize("Mp", [1, 2, 4])
def test_k1_plan_takes_only_clusters_that_fit(held, Mp):
    """A unit spans several clusters only where the card holds all of
    the launch's clusters at once (`fits`, the kernel's occupancy); else
    it is one cluster."""
    R, npair = 500, 1
    plan = cuda_fused.k1_plan(R, 151, Mp, npair, H100_SMS,
                              fits=lambda p: held)
    assert plan.ncl == 1 or Mp * npair * plan.ncl <= held
    _check_plan(plan, R, Mp, npair, H100_SMS)


# ---- K4: K1's kernel on one rank's band of rows (cuda_fused.k4_plan)

# (image rows, labels, planes a launch, ranks, block): the sharded rows'
# K4 launches (parallel/fused_shard.py): cfg1 over 2 and 4 ranks (A/B
# sub-launches: one space, both sides), cfg2's V group and cfg1_tsgm4's
# PB group over 2 (lockstep bands with aprons of min(G, Rl) rows), the
# tests' 22 rows over 3 ranks in blocks of 4, a 3000-row scene over 4
# ranks at L = 256, and one rank a process (cfg1_2proc)
BAND_SHAPES = {
    "cfg1_mesh2": (500, 151, 2, 2, 32, "stagger"),
    "cfg1_mesh4": (500, 151, 2, 4, 32, "stagger"),
    "cfg1_mesh2 G=128": (500, 151, 2, 2, 128, "stagger"),
    "cfg2_mesh2 V": (500, 151, 2, 2, 32, "lockstep"),
    "cfg1_tsgm4_mesh2 PB": (500, 151, 2, 2, 64, "lockstep"),
    "22 rows, 3 ranks, G=4": (22, 9, 2, 3, 4, "lockstep"),
    "22 rows, 3 ranks, G=4 A/B": (22, 9, 2, 3, 4, "stagger"),
    "3000x4000 L=256, 4 ranks": (3000, 256, 2, 4, 64, "stagger"),
    "cfg1_2proc": (500, 151, 2, 1, 32, "stagger"),
}


def _bands(H, n, G, layout):
    """Each rank's (r0, Rl, ship_row) as fused_shard lays its bands out:
    Rl = ceil(H / n) rows from image row k * Rl (stagger; the downstream
    rank reads the upstream one's ship row), or the band with min(G,
    Rl)-row aprons (lockstep, no ship track)."""
    rl = -(-H // n)
    if layout == "stagger":
        return [(k * rl, rl, rl - 1) for k in range(n)]
    B = min(G, rl)
    return [(k * rl - B, rl + 2 * B, -1) for k in range(n)]


def _warp_rows(plan, n, L):
    """Every (CTA, warp) of a unit and the launch rows it runs, as the
    kernel deals them (fused_block_cluster): launch row ((j / band) *
    nc + x) * band + j % band is local row j of CTA x, and a warp takes
    32 / NL local rows at once, warps apart."""
    NL = 16 if L <= 48 else 32
    K = 32 if L > 192 else 3
    rw = 32 // NL
    warps = min(-(-plan.rows // rw), (1024 if K <= 6 else 256) // 32)
    nc = plan.cluster * plan.ncl
    dealt = {}
    for x in range(nc):
        for j in range(plan.rows):
            r = ((j // plan.band) * nc + x) * plan.band + j % plan.band
            if r < n:
                dealt.setdefault(r, []).append((x, (j // rw) % warps))
    return dealt


@pytest.mark.parametrize("name", BAND_SHAPES)
def test_k4_plan_deals_every_band_row_to_one_warp(name):
    """Every local row of a band that lies in the image, aprons included,
    runs in exactly one warp; the rows above row 0 and past the image
    are never run; all ranks' clusters fit the card together."""
    H, L, Mp, n, G, layout = BAND_SHAPES[name]
    share = 1 if name == "cfg1_2proc" else n

    def fits(pl):   # one CTA an SM
        return H100_SMS // pl.cluster

    for r0, Rl, _ in _bands(H, n, G, layout):
        lo, rows = cuda_fused.band_rows(r0, Rl, H)
        assert [lo + x for x in range(rows)] == [
            x for x in range(Rl) if 0 <= r0 + x < H]
        plan = cuda_fused.k4_plan(rows, L, Mp, H100_SMS, share, fits)
        _check_plan(plan, rows, Mp, 1, H100_SMS)
        dealt = _warp_rows(plan, rows, L)
        assert sorted(dealt) == list(range(rows))
        assert all(len(w) == 1 for w in dealt.values())
        # a unit's clusters wait on one another: every rank's must be
        # on the card at once
        assert plan.ncl == 1 or share * Mp * plan.ncl <= fits(plan)
        assert cuda_fused.k4_plan(rows, L, Mp, H100_SMS, share,
                                  fits) == plan


@pytest.mark.parametrize("name", BAND_SHAPES)
def test_k4_only_the_band_edge_row_reads_the_halo(name):
    """A dep row outside the band's launch rows (csrc/fused_wavefront.cuh
    load_dep: the halo track, or +inf) is read only by the band's first
    row (the row above) or its last (the row below), only where that
    row is an image row (the border rule keeps every other dep inside
    the image), and in the A/B stagger it is the row the neighbour band
    ships (its ship_row)."""
    H, L, Mp, n, G, layout = BAND_SHAPES[name]
    bands = _bands(H, n, G, layout)
    for k, (r0, Rl, _) in enumerate(bands):
        lo, rows = cuda_fused.band_rows(r0, Rl, H)
        for r in range(rows):
            img = r0 + lo + r
            for roll in (1, -1):
                dep = r - roll
                if 0 <= dep < rows or not 0 <= img - roll < H:
                    continue
                assert r == (0 if roll > 0 else rows - 1)
                if layout == "stagger":
                    # the neighbour that flows into this band ships it
                    j = k - roll
                    s0, _, ship = bands[j]
                    assert s0 + (ship if roll > 0 else 0) == img - roll


@pytest.mark.parametrize("rows,share,held", [
    (16 * 29056 + 1, 1, None), (500, 133, None), (500, 2, 0), (250, 1, 0)])
def test_k4_plan_refuses_what_the_card_cannot_hold(rows, share, held):
    fits = None if held is None else (lambda pl: held)
    with pytest.raises(ValueError, match="k1_plan|k4_plan"):
        cuda_fused.k4_plan(rows, 151, 2, H100_SMS, share, fits)
