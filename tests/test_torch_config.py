"""Port config parity: the PyTorch package's PipelineConfig must carry the
JAX package's defaults exactly, and round-trip the same way."""

import json

import pytest

import icp4dradar_tpu as jax_pkg
import icp4dradar_tpu_torch as port
from icp4dradar_tpu_torch.interop import config_from_dict


def test_defaults_identical():
    assert port.PipelineConfig().to_dict() == jax_pkg.PipelineConfig().to_dict()


def test_override_json_roundtrip():
    kv = {"icp.max_iterations": 30, "doppler.num_hypotheses": 64,
          "tracking.s2s_suspect_fitness": 10.0, "seed": 3}
    cfg = port.PipelineConfig().override(**kv)
    assert cfg.icp.max_iterations == 30 and cfg.seed == 3
    assert port.PipelineConfig.from_json(cfg.to_json()) == cfg
    assert cfg.to_dict() == jax_pkg.PipelineConfig().override(**kv).to_dict()
    with pytest.raises(KeyError):
        port.PipelineConfig().override(**{"icp.no_such_knob": 1})


def test_config_from_jax_dict():
    jcfg = jax_pkg.PipelineConfig().override(**{"icp.transformation_epsilon": 0.0})
    cfg = config_from_dict(json.loads(json.dumps(jcfg.to_dict())))
    assert isinstance(cfg, port.PipelineConfig)
    assert cfg.icp.transformation_epsilon == 0.0
    assert cfg.to_dict() == jcfg.to_dict()
