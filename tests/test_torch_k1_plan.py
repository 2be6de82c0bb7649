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
