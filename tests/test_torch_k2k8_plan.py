"""K2's and K8's launch plans, without a card.

The plans (ops/cuda_fused.k2_plan, ops/cuda_cost.k8_plan) are plain
Python, the host side of csrc/wta.cu and csrc/cost.cu.  Their
invariants hold here: a run's span is a multiple of 16 bytes, a CTA
asks for no more than the card's 232,448 bytes of shared memory, K2
takes the largest run that fits, and a plan that cannot fit is refused.
The kernels themselves, ragged and misaligned spans included, are held
against their plain versions on the card (tests/test_torch_kernels.py).
This file imports neither jax nor mgm_tpu.
"""
import pytest

from mgm_tpu_torch.ops import cuda_cost, cuda_fused

SMEM = 232_448  # bytes of shared memory an H100 CTA may use

# (L, nspaces) of the K2 launches of the main paths: cfg1 and
# cfg1_tsgm4, cfg2 and cfg4, cfg1_iter3, the cfg3 cells, and the limits
K2_SHAPES = [(151, 2), (151, 3), (167, 2), (42, 3), (1, 1), (1024, 5),
             (1024, 1), (12, 4), (32, 5)]


@pytest.mark.parametrize("L,nspaces", K2_SHAPES)
def test_k2_plan(L, nspaces):
    plan = cuda_fused.k2_plan(L, nspaces)
    assert plan.run in cuda_fused.K2_RUNS and plan.run % 4 == 0
    assert 256 % plan.run == 0 and plan.run <= 64
    assert plan.stages == cuda_fused.K2_STAGES >= 2
    assert plan.smem == cuda_fused.k2_bytes(plan.run, plan.stages, nspaces,
                                            L) <= SMEM
    # the largest run that fits
    for r in cuda_fused.K2_RUNS:
        if r > plan.run:
            assert cuda_fused.k2_bytes(r, plan.stages, nspaces, L) > SMEM
    assert cuda_fused.k2_plan(L, nspaces) == plan


@pytest.mark.parametrize("L,nspaces", [(0, 2), (1025, 2), (151, 0),
                                       (151, 6)])
def test_k2_plan_refuses(L, nspaces):
    with pytest.raises(ValueError, match="k2_plan"):
        cuda_fused.k2_plan(L, nspaces)


@pytest.mark.parametrize("L,nch", [(151, 3), (151, 1), (151, 2), (151, 9),
                                   (5, 3), (1, 1), (1024, 3), (1024, 27)])
def test_k8_plan(L, nch):
    plan = cuda_cost.k8_plan(L, nch)
    assert plan.tx % 4 == 0 and 4 <= plan.tx <= cuda_cost.K8_MAX_RUN
    assert plan.tx * L <= max(cuda_cost.K8_OUT_WORDS, 4 * L)
    assert 4 * plan.tx * L < plan.smem <= SMEM
    assert cuda_cost.k8_plan(L, nch) == plan


def test_k8_plan_refuses():
    with pytest.raises(ValueError, match="k8_plan"):
        cuda_cost.k8_plan(20000, 3)
