"""The port's metric registry (``evreal_tpu_torch/metrics/registry.py``)
and pyiqa bridge against the JAX package's on the CPU: what ``resolve``
prints for gated metrics without their files, for unknown names and for a
pyiqa metric that fails to build, byte for byte against the JAX
registry's stdout; lowercased names; the gate read at resolve time; and
the bridge with the fake ``pyiqa`` module of ``tests/test_pyiqa_bridge.py``
against the JAX bridge's numbers (rtol 1e-6). Registry state is global to
the process: the JAX registry is replaced for each test and the names a
test registers are removed after it."""

import sys
import types

import numpy as np
import pytest
import torch

from evreal_tpu.metrics import registry as jreg
from evreal_tpu_torch.metrics import registry

torch.set_num_threads(1)

NAMES = ["mse", "SSIM", "lpips", "NIQE", "brisque", "maniqa", "nosuch",
         "Psnr"]
GATED_ENV = ("EVREAL_LPIPS_WEIGHTS", "EVREAL_NIQE_PARAMS",
             "EVREAL_BRISQUE_PARAMS", "EVREAL_MANIQA_PARAMS")


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """A fresh JAX registry, every gated file pointed at a missing path,
    no pyiqa importable; the port's test-registered names removed after."""
    monkeypatch.setattr(jreg, "_REGISTRY", {})
    monkeypatch.setattr(jreg, "_builtins_done", False)
    for var in GATED_ENV:
        monkeypatch.setenv(var, str(tmp_path / "absent" / var))
    monkeypatch.setitem(sys.modules, "pyiqa", None)
    before = set(registry._REGISTRY)
    yield tmp_path
    for name in set(registry._REGISTRY) - before:
        registry._REGISTRY.pop(name)


def resolve_both(names, capsys):
    """(port specs, port stdout, JAX specs, JAX stdout)."""
    port = registry.resolve(names)
    port_out = capsys.readouterr().out
    jax_specs = jreg.resolve(names)
    return port, port_out, jax_specs, capsys.readouterr().out


def test_resolve_messages_match_jax(fresh, capsys):
    port, out, jax_specs, jax_out = resolve_both(NAMES, capsys)
    assert out == jax_out
    assert [s.name for s in port] == [s.name for s in jax_specs] == \
        ["mse", "ssim"]
    assert out.splitlines() == [
        "lpips weights unavailable (see tools/convert_lpips.py); "
        "skipping lpips",
        "niqe weights unavailable (see tools/convert_niqe.py); skipping niqe",
        "brisque weights unavailable (see tools/convert_brisque.py); "
        "skipping brisque",
        "maniqa weights unavailable (see tools/convert_maniqa.py); "
        "skipping maniqa",
        "Unknown metric nosuch",
        "Unknown metric Psnr"]


def test_names_are_lowercased(fresh, capsys):
    specs = registry.resolve(["MSE", "Ssim", "mse"])
    assert [s.name for s in specs] == ["mse", "ssim", "mse"]
    assert specs[0] is specs[2]
    assert capsys.readouterr().out == ""
    registry.register("MyMetric", lambda imgs: imgs.mean((1, 2)),
                      no_ref=True)
    (spec,) = registry.resolve(["MYMETRIC"])
    assert spec.name == "mymetric" and spec.no_ref
    assert {"mse", "ssim", "mymetric"} <= set(registry.names())


def test_gate_reads_the_path_at_resolve_time(fresh, monkeypatch, capsys):
    """A file that appears after the first resolve is seen by the next;
    the JAX registry reads it once per process, so it is compared fresh."""
    assert registry.resolve(["niqe"]) == []
    feats = np.random.default_rng(0).normal(0, 1, (40, 36))
    path = fresh / "niqe_params.npz"
    np.savez(path, mu=feats.mean(0), cov=np.cov(feats.T))
    monkeypatch.setenv("EVREAL_NIQE_PARAMS", str(path))
    capsys.readouterr()
    port, out, jax_specs, jax_out = resolve_both(["mse", "niqe"], capsys)
    assert out == jax_out == ""
    assert [s.name for s in port] == [s.name for s in jax_specs]
    assert port[1].no_ref and port[1].host
    assert "niqe" in registry.names()


def test_scipy_missing_line_matches_jax(fresh, monkeypatch, capsys):
    """Without scipy, niqe and brisque print the JAX package's line."""
    err = ImportError("No module named 'scipy'")
    real = registry.importlib.import_module

    def fake_import(name):
        if name.endswith((".niqe", ".brisque")):
            raise err
        return real(name)

    monkeypatch.setattr(registry.importlib, "import_module", fake_import)
    monkeypatch.setattr(jreg, "_builtins_done", True)
    monkeypatch.setattr(jreg, "_nr_import_error", err)
    port, out, _, jax_out = resolve_both(["niqe", "brisque"], capsys)
    assert port == [] and out == jax_out
    assert out.splitlines()[0] == ("niqe unavailable: No module named "
                                   "'scipy' (scipy is required); skipping "
                                   "niqe")


class FakeMetric:
    """``tests/test_pyiqa_bridge.py``'s stand-in: NR is the mean of the
    (N, 3, H, W) batch per item, FR the mean absolute difference; it
    records the batch sizes it sees."""

    def __init__(self, mode):
        self.metric_mode = mode
        self.batches = []

    def __call__(self, img, ref=None):
        assert img.ndim == 4 and img.shape[1] == 3, img.shape
        self.batches.append(img.shape[0])
        if self.metric_mode == "NR":
            return img.mean(dim=(1, 2, 3))
        return (img - ref).abs().mean(dim=(1, 2, 3))


@pytest.fixture
def fake_pyiqa(fresh, monkeypatch):
    mod = types.ModuleType("pyiqa")
    mod.made = {}
    mod.list_models = lambda: ["fakenr", "fakefr"]

    def create(name):
        mod.made[name] = FakeMetric("NR" if name == "fakenr" else "FR")
        return mod.made[name]

    mod.create_metric = create
    monkeypatch.setitem(sys.modules, "pyiqa", mod)
    return mod


def test_bridge_matches_jax_bridge(fake_pyiqa, capsys):
    import jax
    import jax.numpy as jnp

    names = ["mse", "fakenr", "FakeFR", "nosuchmetric"]
    port = registry.resolve(names)
    port_nr = fake_pyiqa.made["fakenr"]  # the JAX resolve makes its own
    out = capsys.readouterr().out
    jax_specs = jreg.resolve(names)
    jax_out = capsys.readouterr().out
    assert out == jax_out == "Unknown metric nosuchmetric\n"
    assert [(s.name, s.no_ref) for s in port] == \
        [(s.name, s.no_ref) for s in jax_specs] == \
        [("mse", False), ("fakenr", True), ("fakefr", False)]
    assert port[1].host and port[2].host
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 1, (10, 16, 24)).astype(np.float32)
    refs = rng.uniform(0, 1, (10, 16, 24)).astype(np.float32)
    got_nr = port[1].score(imgs)
    got_fr = port[2].score(imgs, refs)
    assert port_nr.batches == [4, 4, 2]  # host batches of 4, as the
    # reference's queue
    want_nr = np.asarray(jax.jit(jax.vmap(jax_specs[1].fn))(
        jnp.asarray(imgs)))
    want_fr = np.asarray(jax.jit(jax.vmap(jax_specs[2].fn))(
        jnp.asarray(imgs), jnp.asarray(refs)))
    np.testing.assert_allclose(got_nr, want_nr, rtol=1e-6)
    np.testing.assert_allclose(got_fr, want_fr, rtol=1e-6)
    np.testing.assert_allclose(got_nr, imgs.mean((1, 2)), rtol=1e-6)
    assert port[1].score(imgs[:0]).shape == (0,)
    # registered: a second resolve reuses the instance
    assert registry.resolve(["fakenr"])[0] is port[1]
    for name in ("fakenr", "fakefr"):
        jreg._REGISTRY.pop(name, None)


def test_builtin_names_never_import_pyiqa(fresh, monkeypatch, capsys):
    """pyiqa is looked at only for a name that is not a built-in: a gated
    metric without its file is skipped without it."""
    seen = []
    mod = types.ModuleType("pyiqa")
    mod.list_models = lambda: seen.append(True) or []
    monkeypatch.setitem(sys.modules, "pyiqa", mod)
    registry.resolve(["mse", "lpips", "maniqa"])
    assert seen == []
    registry.resolve(["other"])
    assert seen == [True]
    assert capsys.readouterr().out.endswith("Unknown metric other\n")


def test_construct_failure_is_skipped_like_jax(fresh, monkeypatch, capsys):
    mod = types.ModuleType("pyiqa")
    mod.list_models = lambda: ["deadmetric"]

    def explode(name):
        raise OSError("connection refused downloading weights")

    mod.create_metric = explode
    monkeypatch.setitem(sys.modules, "pyiqa", mod)
    port, out, jax_specs, jax_out = resolve_both(["mse", "deadmetric"],
                                                 capsys)
    assert [s.name for s in port] == [s.name for s in jax_specs] == ["mse"]
    assert out == jax_out
    assert out == ("[metrics] pyiqa metric 'deadmetric' failed to construct "
                   "(OSError: connection refused downloading weights); "
                   "skipping\nUnknown metric deadmetric\n")
