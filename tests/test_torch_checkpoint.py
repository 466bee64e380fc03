"""Verified checkpoints and RetryPolicy of the port
(``mxtpu_torch.resilience.checkpoint`` / ``retry``) held against the JAX
package's (``mxtpu.resilience``).

The ``.mxmf`` manifest is the reference's format byte for byte: a file
either package writes verifies under the other, whole-file and
per-tensor manifests alike, and a damaged file is attributed to the same
tensor and byte offset by both.  Rotation, the previous-good fallback,
the ``ckpt.write`` / ``ckpt.verify`` fault sites and the retry policy's
schedule replay the same scenarios in both packages.
"""

import json
import os
import zlib

import numpy as np
import pytest

from mxtpu.resilience import checkpoint as jax_ckpt
from mxtpu.resilience import fault_plan as jax_fault_plan
from mxtpu.resilience.counters import counters as jax_counters
from mxtpu.resilience.retry import RetryPolicy as JaxRetryPolicy
from mxtpu_torch.resilience import (CorruptCheckpointError, RetryPolicy,
                                    fault_plan)
from mxtpu_torch.resilience import checkpoint as ckpt
from mxtpu_torch.resilience.counters import counters

PACKAGES = {"port": (ckpt, fault_plan, counters),
            "reference": (jax_ckpt, jax_fault_plan, jax_counters)}
#: (writer, verifier)
PAIRS = [("port", "reference"), ("reference", "port"), ("port", "port")]


def _tensors(seed=0, n=4):
    """A payload of n float32 arrays back to back with its per-tensor
    manifest entries."""
    rng = np.random.RandomState(seed)
    blobs, entries, at = [], [], 0
    for i in range(n):
        b = rng.randn(16 + 8 * i).astype(np.float32).tobytes()
        entries.append({"name": "layer%d_weight" % i, "offset": at,
                        "size": len(b), "crc32": zlib.crc32(b) & 0xFFFFFFFF})
        blobs.append(b)
        at += len(b)
    return blobs, entries


def _flip(path, at, n=1):
    buf = bytearray(open(path, "rb").read())
    for i in range(n):
        buf[at + i] ^= 0xFF
    open(path, "wb").write(bytes(buf))


@pytest.mark.parametrize("per_tensor", [False, True],
                         ids=["whole-file", "per-tensor"])
@pytest.mark.parametrize("writer,verifier", PAIRS)
def test_files_verify_under_either_package(tmp_path, writer, verifier,
                                           per_tensor):
    blobs, entries = _tensors()
    path = str(tmp_path / "ckpt.bin")
    mod = PACKAGES[writer][0]
    if per_tensor:
        # the streamed form: a generator of chunks, entries passed along
        mod.write_verified(path, iter(blobs), tensors=entries)
    else:
        mod.write_verified(path, b"".join(blobs))
    man = PACKAGES[verifier][0].verify(path, required=True)
    assert man["size"] == sum(map(len, blobs))
    assert man["tensors"] == (entries if per_tensor else [])
    assert not os.path.exists(path + ".mxmf.next")


@pytest.mark.parametrize("per_tensor", [False, True],
                         ids=["whole-file", "per-tensor"])
def test_manifests_are_byte_equal(tmp_path, per_tensor):
    blobs, entries = _tensors(1)
    out = {}
    for name, (mod, _, _) in PACKAGES.items():
        path = str(tmp_path / ("%s.bin" % name))
        mod.write_verified(path, b"".join(blobs),
                           tensors=entries if per_tensor else None)
        out[name] = open(path + ".mxmf", "rb").read()
    assert out["port"] == out["reference"]
    assert json.loads(out["port"])["format"] == 1


@pytest.mark.parametrize("writer,verifier", PAIRS)
@pytest.mark.parametrize("tensor", [0, 2, 3])
def test_damage_names_the_same_tensor_and_offset(tmp_path, writer,
                                                 verifier, tensor):
    blobs, entries = _tensors(2)
    path = str(tmp_path / "ckpt.bin")
    PACKAGES[writer][0].write_verified(path, b"".join(blobs),
                                       tensors=entries)
    _flip(path, entries[tensor]["offset"] + 5, 3)
    errs = []
    for mod in (PACKAGES[verifier][0], jax_ckpt):
        with pytest.raises(Exception) as ei:
            mod.verify(path, required=True)
        errs.append(ei.value)
    got, want = errs
    assert isinstance(errs[0], CorruptCheckpointError) or verifier != "port"
    assert (got.path, got.offset, str(got)) == (want.path, want.offset,
                                                str(want))
    assert got.offset == entries[tensor]["offset"]
    assert "layer%d_weight" % tensor in str(got)


@pytest.mark.parametrize("case", ["truncated", "missing", "no-manifest",
                                  "bad-manifest", "whole-file-crc"])
def test_corruption_cases_as_the_reference(tmp_path, case):
    """Truncation, a missing payload, a missing or unreadable manifest
    and a CRC mismatch without tensor entries: the same error (message,
    path, offset) from both packages, or the same None."""
    results = []
    for name, (mod, _, _) in PACKAGES.items():
        path = str(tmp_path / ("%s.bin" % name))
        mod.write_verified(path, b"0123456789" * 10)
        if case == "truncated":
            open(path, "r+b").truncate(37)
        elif case == "missing":
            os.remove(path)
        elif case == "no-manifest":
            os.remove(path + ".mxmf")
        elif case == "bad-manifest":
            open(path + ".mxmf", "w").write("{not json")
        else:
            _flip(path, 50)
        try:
            results.append(("ok", mod.verify(path, required=True)))
        except Exception as exc:   # noqa: BLE001 — compared below
            results.append((type(exc).__name__,
                            str(exc).replace(name + ".bin", "X"),
                            os.path.basename(exc.path or "").replace(name,
                                                                     "X"),
                            exc.offset))
    assert results[0] == results[1]
    assert results[0][0] == "CorruptCheckpointError"
    # without required=True a file that never had a manifest passes
    if case == "no-manifest":
        assert ckpt.verify(str(tmp_path / "port.bin")) is None


def test_staged_manifest_is_promoted_after_a_crash(tmp_path):
    """A crash between write_verified's two renames leaves the new payload
    beside a staged ``.mxmf.next``: verify promotes it in both packages;
    a stale staged manifest never is."""
    for mod, _, _ in PACKAGES.values():
        path = str(tmp_path / ("%s.bin" % mod.__name__.split(".")[0]))
        mod.write_verified(path, b"old-bytes")
        new = b"new-bytes-longer"
        man = {"format": 1, "size": len(new),
               "crc32": zlib.crc32(new) & 0xFFFFFFFF, "tensors": []}
        open(path + ".mxmf.next", "w").write(json.dumps(man))
        open(path, "wb").write(new)
        assert mod.verify(path, required=True)["size"] == len(new)
        assert not os.path.exists(path + ".mxmf.next")
        open(path + ".mxmf.next", "w").write(json.dumps(man))  # stale now
        _flip(path, 0)
        with pytest.raises(Exception, match="CRC mismatch"):
            mod.verify(path, required=True)


def test_save_event_and_directory_manifests(tmp_path):
    for name, (mod, _, _) in PACKAGES.items():
        path = str(tmp_path / ("%s.bin" % name))
        mod.write_verified(path, b"payload")
        mod.stamp_save_event(path, "evt-7")
        assert ckpt.save_event(path) == jax_ckpt.save_event(path) == "evt-7"
        root = tmp_path / ("%s_dir" % name)
        (root / "sub").mkdir(parents=True)
        (root / "a.bin").write_bytes(b"aaa")
        (root / "sub" / "b.bin").write_bytes(b"bbbb")
        mod.write_dir_manifest(str(root))
    assert (open(str(tmp_path / "port_dir.mxmf"), "rb").read()
            == open(str(tmp_path / "reference_dir.mxmf"), "rb").read())
    for name in PACKAGES:
        root = str(tmp_path / ("%s_dir" % name))
        for mod, _, _ in PACKAGES.values():
            assert len(mod.verify_dir(root, required=True)["files"]) == 2
        (tmp_path / ("%s_dir" % name) / "sub" / "b.bin").write_bytes(b"bbbX")
        for mod, _, _ in PACKAGES.values():
            with pytest.raises(Exception, match="damaged"):
                mod.verify_dir(root)
    assert ckpt.save_event(str(tmp_path / "nothing")) is None


def test_rotate_history_and_move_with_manifest(tmp_path):
    layouts = []
    for name, (mod, _, _) in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        path = str(d / "ckpt")
        for g in range(4):
            mod.rotate_history(path, keep=3)
            mod.write_verified(path, b"gen-%d" % g)
        layouts.append(sorted(os.listdir(str(d))))
        assert open(path + ".2", "rb").read() == b"gen-1"
        for suffix in ("", ".1", ".2"):
            PACKAGES["reference" if name == "port" else "port"][0].verify(
                path + suffix, required=True)
        mod.move_with_manifest(path + ".2", str(d / "moved"))
        assert not os.path.exists(path + ".2.mxmf")
        mod.verify(str(d / "moved"), required=True)
    assert layouts[0] == layouts[1] == [
        "ckpt", "ckpt.1", "ckpt.1.mxmf", "ckpt.2", "ckpt.2.mxmf",
        "ckpt.mxmf"]


@pytest.mark.parametrize("framework", ["port", "reference"])
def test_checkpoint_set_rotation_and_fallback(tmp_path, framework,
                                             monkeypatch):
    """Keep-last-K rotation (``MXTPU_CKPT_KEEP``), and latest_verified's
    walk past a corrupt and a missing newest checkpoint, with the same
    counter deltas in both packages."""
    mod, _, cnt = PACKAGES[framework]
    monkeypatch.setenv("MXTPU_CKPT_KEEP", "3")
    cs = mod.CheckpointSet(str(tmp_path), name="run")
    before = cnt()
    for step in (10, 20, 30, 40):
        cs.save(step, b"state-%d" % step)
    assert cs.steps() == [20, 30, 40]
    assert cs.latest_verified() == (40, b"state-40")
    _flip(cs.path(40), 2)
    os.remove(cs.path(30))
    assert cs.latest_verified() == (20, b"state-20")
    after = cnt()
    delta = {k: after[k] - before.get(k, 0) for k in
             ("ckpt_writes", "ckpt_corruptions", "ckpt_fallbacks")}
    assert delta == {"ckpt_writes": 4, "ckpt_corruptions": 1,
                     "ckpt_fallbacks": 1}
    _flip(cs.path(20), 0)
    assert cs.latest_verified() is None
    assert cnt()["ckpt_fallbacks"] == after["ckpt_fallbacks"]


@pytest.mark.parametrize("framework", ["port", "reference"])
def test_ckpt_fault_sites(tmp_path, framework):
    """``ckpt.write`` fires before any byte lands (the old checkpoint
    stays intact); ``ckpt.verify`` at each verification; both keyed by
    basename."""
    mod, plan, _ = PACKAGES[framework]
    path = str(tmp_path / "c.bin")
    mod.write_verified(path, b"old")
    with plan("ckpt.write#c.bin@1:raise=OSError(disk full)") as p:
        with pytest.raises(OSError, match="disk full"):
            mod.write_verified(path, b"new")
        mod.write_verified(str(tmp_path / "other.bin"), b"x")
    assert p.stats() == {"ckpt.write": {"hits": 1, "fired": 1}}
    assert open(path, "rb").read() == b"old"
    assert mod.verify(path, required=True)["size"] == 3
    assert not [f for f in os.listdir(str(tmp_path)) if ".tmp." in f]
    with plan("ckpt.verify@2:raise=RuntimeError(torn read)") as p:
        mod.verify(path)
        with pytest.raises(RuntimeError, match="torn read"):
            mod.verify(path)
    assert p.stats() == {"ckpt.verify": {"hits": 2, "fired": 1}}


def test_streamed_write_that_raises_leaves_no_tmp(tmp_path):
    def chunks():
        yield b"abc"
        raise MemoryError("materializing a tensor")

    path = str(tmp_path / "s.bin")
    ckpt.atomic_bytes(path, b"kept")
    with pytest.raises(MemoryError):
        ckpt.write_verified(path, chunks())
    assert os.listdir(str(tmp_path)) == ["s.bin"]
    assert open(path, "rb").read() == b"kept"


# ------------------------------------------------------------ RetryPolicy

class FakeTime:
    def __init__(self):
        self.now = 0.0
        self.slept = []

    def clock(self):
        return self.now

    def sleep(self, s):
        self.slept.append(s)
        self.now += s


def _policy(cls, t, **kw):
    return cls(clock=t.clock, sleep=t.sleep, **kw)


@pytest.mark.parametrize("kw", [dict(), dict(max_attempts=5, base_delay=0.1,
                                             multiplier=3.0, max_delay=1.0),
                                dict(max_attempts=1)])
def test_retry_backoff_schedule_as_the_reference(kw):
    mine, ref = RetryPolicy(**kw), JaxRetryPolicy(**kw)
    assert [mine.backoff(a) for a in range(1, 8)] == \
        [ref.backoff(a) for a in range(1, 8)]
    assert repr(mine) == repr(ref)


@pytest.mark.parametrize("fail", [0, 2, 4, 9])
@pytest.mark.parametrize("deadline", [None, 0.3])
def test_retry_call_as_the_reference(fail, deadline):
    """A function failing its first ``fail`` calls: the same result or
    the same re-raised exception (with its attempt count), the same
    sleeps, and the same counter deltas."""
    outcomes = []
    for cls, cnt in ((RetryPolicy, counters), (JaxRetryPolicy,
                                                jax_counters)):
        t = FakeTime()
        pol = _policy(cls, t, max_attempts=5, base_delay=0.1,
                      deadline=deadline)
        calls = []

        def flaky(x):
            calls.append(x)
            if len(calls) <= fail:
                raise ConnectionError("try %d" % len(calls))
            return x * 2

        before = cnt()
        try:
            out = ("ok", pol.call(flaky, 21))
        except ConnectionError as exc:
            out = ("raised", str(exc), exc.mxtpu_retry_attempts)
        after = cnt()
        outcomes.append((out, t.slept, len(calls),
                         after["retries"] - before["retries"],
                         after["retry_exhaustions"]
                         - before["retry_exhaustions"]))
    assert outcomes[0] == outcomes[1]


def test_retry_on_and_wrap():
    t = FakeTime()
    pol = _policy(RetryPolicy, t, max_attempts=3, retry_on=(OSError,))
    calls = []

    @pol.wrap
    def op(n):
        """doc kept"""
        calls.append(n)
        if len(calls) == 1:
            raise OSError("transient")
        if n < 0:
            raise ValueError("not retried")
        return n

    assert op(4) == 4 and len(calls) == 2
    assert op.__name__ == "op" and op.__doc__ == "doc kept"
    calls.clear()
    calls.append(None)              # the next call does not fail first
    with pytest.raises(ValueError):
        op(-1)
    assert len(calls) == 2          # a non-retryable error: no second try
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0)
