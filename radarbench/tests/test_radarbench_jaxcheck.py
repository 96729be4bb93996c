"""The check that no module of JAX or the JAX package was loaded compares
whole top-level names: the port's name begins with the JAX package's."""

import pytest

from radarbench.harness import forbidden_modules


def test_port_passes():
    assert forbidden_modules(["icp4dradar_tpu_torch", "icp4dradar_tpu_torch.models.scan_to_map",
                              "radarbench.harness", "torch", "jaxtyping", "numpy"]) == []


def test_jax_package_and_jax_fail():
    assert forbidden_modules(["icp4dradar_tpu"]) == ["icp4dradar_tpu"]
    assert forbidden_modules(["icp4dradar_tpu.models.scan_to_scan"]) == ["icp4dradar_tpu"]
    assert forbidden_modules(["jax.numpy", "jaxlib.xla_client", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


def test_a_run_loads_neither(tiny):
    import sys

    import torch

    from radarbench.harness import run_cell

    run_cell(tiny, "s2s-dense4096", 5, 2.0, False, torch.device("cpu"), 0.0,
             log=lambda *a, **k: None)
    assert forbidden_modules(sys.modules) == []


@pytest.mark.parametrize("where", ["metric", "reference"])
def test_no_result_once_jax_is_loaded_after_the_window(tiny, benchmark_json, tmp_path,
                                                       monkeypatch, where):
    """JAX loaded after the window closed, by a per-layer reader or by the
    reference, still withholds the result: the look comes last."""
    import copy
    import sys

    import torch

    from radarbench.harness import Registry, run_cell

    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(stub))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    bench = copy.deepcopy(benchmark_json)
    if where == "metric":
        (tiny.dir / "metrics" / "jax_user.py").write_text(
            "def read(run):\n    import jax\n    return 1.0\n")
        bench["per_layer"].append({"name": "jax_user", "unit": "share", "better": "lower",
                                   "source": "program_counter", "layer": "test",
                                   "moves": "scans_per_s", "workloads": ["s2s-dense4096"]})
    else:
        from radarbench.reference import s2s

        real = s2s.run

        def run(*a, **k):
            import jax  # noqa: F401
            return real(*a, **k)

        monkeypatch.setattr(s2s, "run", run)
    r = run_cell(Registry(tiny.dir, bench), "s2s-dense4096", 5, 2.0, where == "metric",
                 torch.device("cpu"), 0.0, log=lambda *a, **k: None)
    assert "jax" in sys.modules and r is None
    del sys.modules["jax"]
