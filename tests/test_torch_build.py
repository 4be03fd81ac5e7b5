"""``repro_torch.kernels._build.build`` without ``nvcc``: stand-in commands
(``sleep`` of different lengths, then the file the step writes) check that
each compile is timed to its own exit, that a source of several units is
linked once its units are done, and that a failing compile raises with its
output and leaves no library behind."""
import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import KERNELS, _build  # noqa: E402


class StandIn(_build.Kernel):
    """A kernel whose compiles sleep ``waits`` seconds (one per unit) and
    whose link (several units) sleeps ``link`` seconds."""

    def __init__(self, name, out_dir, waits, link=0.0, fail=False):
        super().__init__(name, "common.cuh", replaces="-", functions={},
                         units=len(waits))
        self.out_dir, self.waits, self.link, self.fail = (out_dir, waits,
                                                          link, fail)

    def library_path(self):
        return self.out_dir / f"{self.name}.so"

    def commands(self, out):
        def step(wait, path, ok=True):
            return ["sh", "-c", f"sleep {wait}; echo step {self.name}; "
                    + (f"touch {path}" if ok else "exit 3")]
        if len(self.waits) == 1:
            return [step(self.waits[0], out, not self.fail)], None
        objs = [f"{out}.u{u}.o" for u in range(len(self.waits))]
        return ([step(w, o, not (self.fail and u == 0))
                 for u, (w, o) in enumerate(zip(self.waits, objs))],
                step(self.link, out))


@pytest.mark.parametrize("order", ["slow_first", "fast_first"])
def test_build_stamps_are_per_process(tmp_path, monkeypatch, order):
    """Each library's seconds are its own compile's (and link's), whatever
    the order the kernels are listed in; everything runs at once, so the
    wall is the slowest chain, not the sum."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    ks = {"slow": StandIn("slow", tmp_path, [1.2]),
          "fast": StandIn("fast", tmp_path, [0.1]),
          "split": StandIn("split", tmp_path, [0.5, 0.2], link=0.3)}
    for name, k in ks.items():         # distinct stems for the report
        k.source = tmp_path / f"{name}.cu"
    seq = list(ks.values()) if order == "slow_first" \
        else list(reversed(ks.values()))
    t0 = time.perf_counter()
    took = _build.build(seq)
    wall = time.perf_counter() - t0
    assert set(took) == {"slow", "fast", "split", "split.u0", "split.u1"}
    assert 0.1 <= took["fast"] < 0.6, took
    assert 1.2 <= took["slow"] < 1.9, took
    assert 0.5 <= took["split.u0"] < 1.0 and 0.2 <= took["split.u1"] < 0.5
    # linked after its slower unit: 0.5 + 0.3
    assert took["split.u0"] + 0.3 <= took["split"] < 1.5, took
    assert wall < 1.2 + 0.1 + 0.5 + 0.3 + 0.2, wall
    assert all(k.library_path().exists() for k in ks.values())
    # the units' objects are gone once linked
    assert not list(tmp_path.glob("*.o"))
    # nothing is rebuilt while its library is there
    assert _build.build(seq) == {}


def test_build_failure_raises_with_output_and_keeps_no_library(
        tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    bad = StandIn("bad", tmp_path, [0.1, 0.1], fail=True)
    bad.source = tmp_path / "bad.cu"
    good = StandIn("good", tmp_path, [0.1])
    good.source = tmp_path / "good.cu"
    with pytest.raises(RuntimeError, match="step bad"):
        _build.build([bad, good])
    assert not bad.library_path().exists()
    assert good.library_path().exists()
    assert not list(tmp_path.glob("*.o")) and \
        not list(tmp_path.glob("*.tmp*"))


def test_split_source_hash_and_commands(monkeypatch):
    """K2a / K2b's source builds as units linked into one library: every
    unit compiles the same source with its own -DREPRO_UNIT and the flags
    without -shared; the link takes the flags with it; the unit count is
    part of the library's hash."""
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    dq = next(k for k in KERNELS if k.name.endswith("bwd_dq"))
    dkv = next(k for k in KERNELS if k.name.endswith("bwd_dkv"))
    assert dq.units == dkv.units > 1
    assert dq.library_path() == dkv.library_path()
    out = dq.library_path()
    compiles, link = dq.commands(out)
    assert len(compiles) == dq.units
    for u, cmd in enumerate(compiles):
        assert cmd[-1] == str(dq.source) and "-shared" not in cmd
        assert f"-DREPRO_UNIT={u}" in cmd and \
            f"-DREPRO_UNITS={dq.units}" in cmd
        assert [f for f in cmd if f in _build.NVCC_FLAGS] == \
            _build.UNIT_FLAGS
    assert link[1:1 + len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS
    assert link[-dq.units:] == [c[c.index("-o") + 1] for c in compiles]
    one = _build.Kernel(dq.name, str(dq.source.relative_to(
        _build.KERNELS_DIR)), replaces="-", functions={})
    assert one.library_path() != out
    compiles, link = one.commands(one.library_path())
    assert link is None and len(compiles) == 1 and "-shared" in compiles[0]
