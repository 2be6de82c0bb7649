"""K5's launch plan (ops/wavefront.k5_plan) at the shapes the dense paths
give it.

The plan is plain Python, so its invariants hold here without a card:
every (plane, row) of a pass group lies in exactly one warp slot, every
CTA of a launch fits the card at once for the occupancy given (the
CTAs' rows wait on one another), a CTA asks for no more than the card's
232,448 bytes of shared memory and no more threads than its instance
allows, a CTA's counts stay within int32, the plan is a pure function
of the shape, and a launch the card cannot hold is refused.  (The
labels a lane follow from L in the kernel, csrc/wavefront.cu.)  This
file imports neither jax nor mgm_tpu.
"""
import pytest

from mgm_tpu_torch.ops import aggregate as agg
from mgm_tpu_torch.ops import wavefront as wf

H100_SMS = 132  # an H100 SXM's streaming multiprocessors
HELD = 396      # CTAs of 8 warps an H100 holds at three a SM

# (H, W, L, ndir, TSGM, images): the dense paths' runs (PERF.md §4), each
# pass group one K5 launch of (passes * images) planes
RUNS = {
    "ncc": (500, 700, 151, 8, 2, 2),
    "ncc_iter3": (500, 700, 167, 8, 2, 2),
    "mgm_o": (500, 700, 151, 8, 2, 1),
    "full_16dir knight": (500, 700, 151, 16, 2, 2),
    "mgm_o 4000x3000 L=256": (3000, 4000, 256, 8, 2, 1),
    "L=1": (40, 60, 1, 8, 2, 2),
    "L=1024": (64, 96, 1024, 16, 4, 2),
}


def _groups(H, W, ndir, mgm, images, knight_only):
    """(M, R, C, slope) of each pass group's K5 launch."""
    out = []
    for pids in agg._pass_groups(ndir, mgm):
        plan = agg.group_plan(pids, H, W, mgm)
        if knight_only and not plan.knight:
            continue
        out.append((len(pids) * images, plan.R, plan.C, plan.slope))
    return out


def _slots(plan, M, R, L):
    """The (plane, row) each warp slot of the launch takes, as the kernel
    maps them (wavefront_rows): band beta to CTA beta mod ctas, its row j
    to warp j, a warp holding the row of 32 / NL planes."""
    rw = 2 if L <= 48 else 1
    mp = -(-M // rw)
    nbands = mp * -(-R // plan.warps)
    got = []
    for x in range(plan.ctas):
        for beta in range(x, nbands, plan.ctas):
            b, g = divmod(beta, mp)
            for j in range(plan.warps):
                r = b * plan.warps + j
                got += [(m, r) for m in range(g * rw, g * rw + rw)
                        if r < R and m < M]
    return got, nbands


def _check_plan(plan, M, R, C, L, held):
    assert plan.ctas >= 1 and plan.warps >= 1
    # every CTA resident at once, within the instance's CTA size
    assert plan.ctas <= held
    assert plan.warps * 32 <= (512 if L <= 192 else 256)
    assert 4 * plan.warps <= plan.smem <= 232_448
    got, nbands = _slots(plan, M, R, L)
    assert sorted(got) == [(m, r) for m in range(M) for r in range(R)]
    # a CTA's counts (its bands times C) fit an int32
    assert -(-nbands // plan.ctas) * C < 2**31


@pytest.mark.parametrize("name", RUNS)
def test_k5_plan_invariants(name):
    H, W, L, ndir, mgm, images = RUNS[name]
    for M, R, C, slope in _groups(H, W, ndir, mgm, images,
                                  "knight" in name):
        plan = wf.k5_plan(M, R, C, slope, L, H100_SMS, lambda w: HELD)
        _check_plan(plan, M, R, C, L, HELD)
        # a pure function of the shape
        wf.k5_plan(3, 7, 5, 1, 6, H100_SMS)
        assert wf.k5_plan(M, R, C, slope, L, H100_SMS,
                          lambda w: HELD) == plan


@pytest.mark.parametrize("held", [1, 2, 7, 132, 1000])
@pytest.mark.parametrize("M,R,C,slope,L", [
    (4, 700, 500, 2, 151), (8, 500, 700, 1, 151), (3, 13, 17, 1, 6),
    (1, 1, 1, 1, 1), (2, 9, 4, 2, 1024)])
def test_k5_plan_takes_only_ctas_that_fit(held, M, R, C, slope, L):
    """Any occupancy: never more CTAs than the card holds at once, every
    row still covered (a CTA then takes several bands)."""
    plan = wf.k5_plan(M, R, C, slope, L, H100_SMS, lambda w: held)
    _check_plan(plan, M, R, C, L, held)


@pytest.mark.parametrize("held", [0, -1])
def test_k5_plan_refuses_a_launch_the_card_cannot_hold(held):
    with pytest.raises(ValueError, match=r"k5_plan: .*4 planes of 700x500"):
        wf.k5_plan(4, 700, 500, 2, 151, H100_SMS, lambda w: held)


@pytest.mark.parametrize("M,R,C,slope,L", [
    (0, 7, 5, 1, 6), (4, 0, 5, 1, 6), (4, 7, 0, 1, 6), (4, 7, 5, 0, 6),
    (4, 7, 5, 1, 0), (4, 7, 5, 1, 1025)])
def test_k5_plan_refuses_shapes_beyond_the_kernel(M, R, C, slope, L):
    with pytest.raises(ValueError, match="k5_plan"):
        wf.k5_plan(M, R, C, slope, L, H100_SMS)


# K5 on a band: the band's rows, blocks of 64 fronts, the card shared by
# the ranks on it (ncc_mesh2's bands: 250 of 500 rows, 350 of 700
# columns; H = 9 over 4 ranks: 3 rows)
@pytest.mark.parametrize("share", [1, 2, 4])
@pytest.mark.parametrize("M,R,C,slope,L", [
    (2, 250, 700, 1, 151), (2, 350, 500, 2, 151), (2, 3, 26, 2, 49),
    (4, 167, 700, 1, 6)])
def test_k5_band_plan(share, M, R, C, slope, L):
    held = HELD // share
    plan = wf.k5_plan(M, R, C, slope, L, H100_SMS // share,
                      lambda w: held, G=64)
    _check_plan(plan, M, R, C, L, held)
    # the bands a block's fronts keep busy get a CTA each, where they fit
    rw = 2 if L <= 48 else 1
    busy = -(-M // rw) * (-(-(C + 64) // (slope * plan.warps)) + 2)
    assert plan.ctas == min(busy, held, -(-M // rw) * -(-R // plan.warps))
