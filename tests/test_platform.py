"""The one device-capability decision (utils/devices.py) and what
follows it: engine choice (engine/run.py) and batch geometry
(engine/planner.py).  Devices are monkeypatched, so these run on the
CPU suite."""

import jax
import pytest

from dsk_tpu.engine import run as run_mod
from dsk_tpu.engine.planner import plan_resources
from dsk_tpu.engine.run import RunParams, _engine_choice, _engine_n_chips
from dsk_tpu.utils.devices import on_accelerator


class _Dev:
    def __init__(self, platform):
        self.platform = platform


def _devices(monkeypatch, platform, n=1):
    monkeypatch.setattr(jax, "devices", lambda *a: [_Dev(platform)] * n)


@pytest.mark.parametrize("platform", ["gpu", "cuda", "rocm"])
def test_single_accelerator_selects_dist(monkeypatch, platform):
    """One card runs the mesh engine (spill, streamed store, -wire)."""
    _devices(monkeypatch, platform)
    assert on_accelerator()
    assert _engine_choice(RunParams(file="x")) == "dist"
    assert _engine_n_chips("dist") == 1


def test_single_cpu_selects_simple_and_mesh_selects_dist(monkeypatch):
    _devices(monkeypatch, "cpu")
    assert not on_accelerator()
    assert _engine_choice(RunParams(file="x")) == "simple"
    _devices(monkeypatch, "cpu", n=8)
    assert _engine_choice(RunParams(file="x")) == "dist"
    assert _engine_n_chips("dist") == 8


def test_explicit_engine_is_kept(monkeypatch):
    _devices(monkeypatch, "gpu")
    assert _engine_choice(RunParams(file="x", engine="simple")) == "simple"


def test_failed_device_probe_raises(monkeypatch):
    """A broken device setup must not silently pick an engine."""

    def broken(*a):
        raise RuntimeError("no backend")

    monkeypatch.setattr(jax, "devices", broken)
    with pytest.raises(RuntimeError, match="no backend"):
        _engine_choice(RunParams(file="x"))


@pytest.mark.parametrize(
    "platform,windows", [("gpu", 2 << 20), ("cpu", 1 << 18)]
)
def test_planner_batch_geometry_follows_capability(
    monkeypatch, data_dir, platform, windows
):
    _devices(monkeypatch, platform)
    plan = plan_resources(
        str(data_dir / "read50x_ref10K_e001.fasta.gz"), 27, sample=False
    )
    nw = plan.row_len - 27 + 1
    want = max(256, min(8192, round(windows / nw)))
    assert plan.batch_rows == -(-want // 256) * 256
    assert plan.batch_rows % 256 == 0


def test_execute_on_one_accelerator_streams_through_dist(
    monkeypatch, data_dir, tmp_path
):
    """execute() on one (monkeypatched) accelerator builds the mesh
    engine, so spill is allowed and the store streams."""
    seen = {}

    def spy(*a, **kw):
        seen["spill"] = kw.get("spill")
        seen["n_chips"] = kw.get("n_chips")
        raise StopIteration  # stop before any device work

    monkeypatch.setattr(run_mod, "plan_resources", spy)
    _devices(monkeypatch, "gpu")
    with pytest.raises(StopIteration):
        run_mod.execute(RunParams(
            file=str(data_dir / "readN.fasta"), kmer_size=21, spill="on",
            out=str(tmp_path / "o"), verbose=0,
        ))
    assert seen == {"spill": "on", "n_chips": 1}
