"""The port's package surface and profiling helpers against mgm_tpu's."""
import os

import torch

import mgm_tpu
import mgm_tpu_torch
from mgm_tpu_torch import stereo
from mgm_tpu_torch.utils import load_state, save_state, timed, trace


def test_package_surface_matches_mgm_tpu():
    assert mgm_tpu_torch.__all__ == mgm_tpu.__all__
    assert mgm_tpu_torch.__version__ == mgm_tpu.__version__ == "0.3.0"
    for name in mgm_tpu_torch.__all__:
        assert callable(getattr(mgm_tpu_torch, name)), name
    from mgm_tpu_torch import tiled_disparity
    from mgm_tpu_torch.runner import tiled_disparity as runner_tiled
    assert tiled_disparity is runner_tiled


def test_utils_exports_match_mgm_tpu():
    import mgm_tpu.utils as jutils
    import mgm_tpu_torch.utils as tutils

    names = ("trace", "timed", "save_state", "load_state")
    assert all(hasattr(jutils, n) and hasattr(tutils, n) for n in names)
    assert (save_state, load_state) == (tutils.save_state,
                                        tutils.load_state)


def test_timed_prints_its_line(capsys):
    with timed("solve", sync=[torch.ones(3), {"a": torch.zeros(2)}]):
        torch.ones(4).sum()
    out = capsys.readouterr().out
    assert out.startswith("[solve] ") and out.rstrip().endswith(" ms")
    float(out.split()[1])


def test_trace_writes_a_file(tmp_path):
    with trace(str(tmp_path)):
        (torch.arange(16.0).reshape(4, 4) @ torch.ones(4, 4)).sum()
    files = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path)
             for f in fs]
    assert any(f.endswith(".pt.trace.json") for f in files), files


def test_energy_dump_is_the_fixed_path():
    assert stereo.ENERGY_DUMP == "/tmp/ENERGY_L1trunc.tif"
