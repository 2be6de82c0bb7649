"""The PyTorch port's configuration against mgm_tpu's, and its imports."""
import dataclasses
import os
import subprocess
import sys

import pytest

import mgm_tpu.config as jcfg
from mgm_tpu.models import PRESETS as JAX_PRESETS
from mgm_tpu_torch import config as tcfg
from mgm_tpu_torch.models import PRESETS, get_preset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(cls):
    return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]


def test_config_fields_and_registries_match():
    assert _fields(tcfg.MGMConfig) == _fields(jcfg.MGMConfig)
    assert dataclasses.asdict(tcfg.MGMConfig()) == \
        dataclasses.asdict(jcfg.MGMConfig())
    for name in ("DISTANCES", "PREFILTERS", "REFINEMENTS"):
        assert getattr(tcfg, name) == getattr(jcfg, name)


@pytest.mark.parametrize("kw", [
    dict(distance="census"), dict(prefilter="census"),
    dict(distance="bogus", prefilter="sobel_x", refinement="nope"),
])
def test_config_resolution_matches(kw):
    assert dataclasses.asdict(tcfg.MGMConfig(**kw)) == \
        dataclasses.asdict(jcfg.MGMConfig(**kw))


@pytest.mark.parametrize("kw", [dict(ndir=17), dict(mgm=5)])
def test_config_rejects_what_jax_rejects(kw):
    with pytest.raises(ValueError):
        jcfg.MGMConfig(**kw)
    with pytest.raises(ValueError):
        tcfg.MGMConfig(**kw)


@pytest.mark.parametrize("name", sorted(JAX_PRESETS))
def test_presets_match_field_by_field(name):
    assert sorted(PRESETS) == sorted(JAX_PRESETS)
    assert dataclasses.asdict(PRESETS[name]) == \
        dataclasses.asdict(JAX_PRESETS[name])
    over = dict(dmin=-50, dmax=50)
    assert dataclasses.asdict(get_preset(name, **over)) == \
        dataclasses.asdict(JAX_PRESETS[name].replace(**over))


@pytest.mark.parametrize("name", sorted(JAX_PRESETS))
def test_from_jax_round_trips(name):
    j = JAX_PRESETS[name]
    t = tcfg.from_jax(j)
    assert isinstance(t, tcfg.MGMConfig)
    assert t == PRESETS[name]
    assert tcfg.from_jax(dataclasses.asdict(j)) == t
    assert jcfg.MGMConfig(**dataclasses.asdict(t)) == j


def test_from_jax_rejects_other_types():
    with pytest.raises(TypeError):
        tcfg.from_jax(42)


def test_port_imports_no_jax():
    code = ("import sys, mgm_tpu_torch, mgm_tpu_torch.cli, "
            "mgm_tpu_torch.io, mgm_tpu_torch.models, mgm_tpu_torch.synthetic, "
            "mgm_tpu_torch.mrf, mgm_tpu_torch.mrf_cli, mgm_tpu_torch.solver, "
            "mgm_tpu_torch.ops.aggregate, mgm_tpu_torch.ops.cost, "
            "mgm_tpu_torch.ops.wavefront, mgm_tpu_torch.ops.refine, "
            "mgm_tpu_torch.ops.census, mgm_tpu_torch.ops.prefilter, "
            "mgm_tpu_torch.ops.energy, mgm_tpu_torch.runner, "
            "mgm_tpu_torch.utils.checkpoint, mgm_tpu_torch.utils.profiling, "
            "mgm_tpu_torch.parallel, mgm_tpu_torch.parallel.distributed; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'mgm_tpu' "
            "or m.startswith('mgm_tpu.')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
