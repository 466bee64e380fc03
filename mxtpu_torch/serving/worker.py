"""Subprocess replica worker: one engine per OS process, served over a
length-prefixed pipe RPC loop (the port of ``mxtpu/serving/worker.py``).

:func:`main` is the entrypoint a
:class:`~mxtpu_torch.serving.SubprocessReplica` spawns.  The worker reads
ONE JSON init frame on stdin (engine factory spec, kwargs, replica id,
codec), builds its engine, wraps it in the in-process adapter
(:class:`~mxtpu_torch.serving.transport.InProcessReplica` — all
tag/cursor/restart/drain semantics are REUSED, not reimplemented), and
then answers one response frame per request frame until EOF or a
``shutdown`` RPC.  The engine runs where its factory puts it: the CUDA
card unless the factory's kwargs name another device.

Wire format:

- every frame is ``>I``-packed payload length + payload bytes;
- the init frame and its response are always JSON; subsequent frames
  use the negotiated codec (``"json"`` default, ``"msgpack"`` when
  requested and importable — never assumed present);
- requests are ``{"id": N, "method": ..., "params": {...}}``;
  responses ``{"id": N, "ok": true, "result": ...}`` or ``{"id": N,
  "ok": false, "error": {"type", "msg", "attrs"}}`` — typed engine
  rejections (``LoadShedError`` family, ``ReplicaDownError``) marshal
  their structured attributes so the parent reconstructs the REAL
  exception type and the gateway/router handling works unchanged;
- everything on the wire is host data: token id lists, spec dicts,
  counter tuples.  Device tensors never cross (results are the engines'
  CPU tensors, sent as nested int lists).

Determinism: the worker only runs code while answering an RPC, so its
tracer events (engine admissions, prefix hits, decode ticks, ...) are
drained in order onto each response (``events`` field, tick/noise
stripped) and re-emitted by the parent under ITS counter clock — one
timeline per request spanning both processes, byte-identical
``to_json`` across reruns.  Worker-side events already resolve to the
gateway rid: the internal ``InProcessReplica.submit`` registers the
engine-rid alias in THIS process's tracer.

Stray output can never corrupt framing: the worker rebinds
``sys.stdout`` to stderr after capturing the raw pipe, so a library
``print()`` lands in the log, not the frame stream.
"""

from __future__ import annotations

import json
import os
import struct
import sys
from typing import Any, Dict, Optional, Tuple

import numpy as onp
import torch

__all__ = ["read_frame", "write_frame", "make_codec", "seeded_llama_tiny",
           "demo_paged_engine", "demo_slot_engine", "main"]


# -- framing (shared by both ends) ----------------------------------------

def write_frame(stream, payload: bytes) -> None:
    """One length-prefixed frame: 4-byte big-endian length + payload."""
    stream.write(struct.pack(">I", len(payload)))
    stream.write(payload)
    stream.flush()


def _read_exact(stream, n: int) -> Optional[bytes]:
    """Exactly ``n`` bytes, looping over short reads (the parent runs
    the pipe UNBUFFERED so its readiness waiter sees the true fd state
    — raw reads may return short); None on EOF."""
    chunks = []
    got = 0
    while got < n:
        chunk = stream.read(n - got)
        if not chunk:
            return None
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_frame(stream) -> Optional[bytes]:
    """Read one frame; None on EOF (a closed pipe / dead peer)."""
    header = _read_exact(stream, 4)
    if header is None:
        return None
    (n,) = struct.unpack(">I", header)
    return _read_exact(stream, n) if n else b""


def make_codec(name: str):
    """``(dumps, loads)`` byte codecs for RPC payloads.  ``"json"`` is
    the always-available default; ``"msgpack"`` is opt-in
    (``MXTPU_RPC_CODEC``) and raises a clear error when the package is
    absent — it is never assumed installed."""
    if name == "json":
        return (lambda obj: json.dumps(obj, sort_keys=True,
                                       separators=(",", ":")).encode(),
                lambda buf: json.loads(buf.decode()))
    if name == "msgpack":
        try:
            import msgpack
        except ImportError as exc:
            raise ValueError(
                "MXTPU_RPC_CODEC=msgpack but msgpack is not importable "
                "in this environment — use the default json codec"
            ) from exc
        return (lambda obj: msgpack.packb(obj, use_bin_type=True),
                lambda buf: msgpack.unpackb(buf, raw=False,
                                            strict_map_key=False))
    raise ValueError("unknown RPC codec %r (valid: json, msgpack)"
                     % (name,))


# -- wire <-> host value helpers ------------------------------------------

def _enc_tag(tag) -> Any:
    """Tags cross the wire as JSON-able values; tuples (the gateway's
    ``(rid, dispatch_gen)``) become lists and are re-tupled on read."""
    return list(tag) if isinstance(tag, tuple) else tag


def _dec_tag(tag) -> Any:
    return tuple(tag) if isinstance(tag, list) else tag


def encode_poll(polled) -> Dict[str, Any]:
    """Marshal one ``ReplicaTransport.poll`` result to host data.  Dict
    keys are tags (maybe tuples), so ``tokens`` crosses as pairs;
    finished results are materialized to nested int lists."""
    tokens, finished, restarts = polled
    return {
        "tokens": [[_enc_tag(t), [int(x) for x in toks]]
                   for t, toks in tokens.items()],
        "finished": [[_enc_tag(t), st,
                      (None if res is None else res.tolist()),
                      err]
                     for t, st, res, err in finished],
        "restarts": [_enc_tag(t) for t in restarts],
    }


def decode_poll(wire: Dict[str, Any]):
    """Parent-side inverse of :func:`encode_poll` (results rebuilt as
    int32 CPU tensors, tags re-tupled)."""
    tokens = {_dec_tag(t): [int(x) for x in toks]
              for t, toks in wire["tokens"]}
    finished = []
    for t, st, seq, err in wire["finished"]:
        res = (None if seq is None
               else torch.from_numpy(onp.asarray(seq, dtype=onp.int32)))
        finished.append((_dec_tag(t), st, res, err))
    return tokens, finished, [_dec_tag(t) for t in wire["restarts"]]


def marshal_error(exc: BaseException) -> Dict[str, Any]:
    """Flatten an exception into wire form, keeping the structured
    attributes the service layer's typed handling reads."""
    err: Dict[str, Any] = {"type": type(exc).__name__, "msg": str(exc)}
    attrs = {}
    for a in ("queue_depth", "limit", "retry_after_ticks", "permanent",
              "method", "ticks", "exit_code"):
        if hasattr(exc, a):
            v = getattr(exc, a)
            if v is None or isinstance(v, (bool, int, float, str)):
                attrs[a] = v
    if attrs:
        err["attrs"] = attrs
    return err


def resolve_factory(spec: str):
    """``"module:callable"`` -> the callable.  The factory builds and
    returns ONE engine in the worker process (e.g.
    ``"mxtpu_torch.serving.worker:demo_paged_engine"``)."""
    if not isinstance(spec, str) or ":" not in spec:
        raise ValueError(
            "engine factory spec must be 'module:callable', got %r"
            % (spec,))
    mod_name, _, fn_name = spec.partition(":")
    import importlib
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, fn_name, None)
    if not callable(fn):
        raise ValueError("factory %r is not a callable in %s"
                         % (fn_name, mod_name))
    return fn


# -- demo engine factories (tests / bench / docs) -------------------------

def seeded_llama_tiny(seed=77, vocab_size=50, device=None):
    """The demo factories' model: a port ``llama_tiny`` whose every
    weight (RMSNorm gains aside, which stay 1) is drawn Normal(0, 0.5)
    from a ``torch.Generator`` seeded with ``seed`` on ``device``, in
    parameter order.  Same seed and device => bit-identical weights in
    every process, which is what makes a drained request's requeue on
    another worker — or an in-process engine over this model — produce
    the identical stream.  ``device`` is the card unless named; with no
    device named and no CUDA present this raises."""
    from ..base import resolve_device
    from ..models.transformer import llama_tiny

    dev = resolve_device(device)
    model = llama_tiny(vocab_size=vocab_size, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not name.endswith("norm.weight"):
                p.normal_(0.0, 0.5, generator=gen)
    return model


def demo_paged_engine(seed=77, vocab_size=50, num_slots=2,
                      max_length=32, block_size=8, prefill_chunk=8,
                      pin_bytes="1MiB", ledger_tag="r0", device=None,
                      **kw):
    """The exemplar worker factory: :func:`seeded_llama_tiny` behind a
    ``PagedContinuousBatchingEngine`` on ``device`` (the card unless
    named)."""
    from ..parallel.serving import PagedContinuousBatchingEngine
    model = seeded_llama_tiny(seed, vocab_size, device)
    return PagedContinuousBatchingEngine(
        model, num_slots=num_slots, max_length=max_length,
        block_size=block_size, prefill_chunk=prefill_chunk,
        pin_bytes=pin_bytes, ledger_tag=ledger_tag, device=model.device,
        **kw)


def demo_slot_engine(seed=77, vocab_size=50, num_slots=2,
                     max_length=32, ledger_tag="r0", device=None, **kw):
    """Slot-engine sibling of :func:`demo_paged_engine` (no page pool;
    prefix_probe is always 0)."""
    from ..parallel.serving import ContinuousBatchingEngine
    model = seeded_llama_tiny(seed, vocab_size, device)
    return ContinuousBatchingEngine(
        model, num_slots=num_slots, max_length=max_length,
        ledger_tag=ledger_tag, device=model.device, **kw)


# -- the worker loop ------------------------------------------------------

def _dispatch(rep, method: str,
              params: Dict[str, Any]) -> Tuple[Any, bool]:
    """One RPC against the internal InProcessReplica; returns
    ``(result, shutdown)``."""
    if method == "submit":
        spec = dict(params["spec"])
        spec["prompt"] = onp.asarray(spec["prompt"], dtype=onp.int32)
        rid = rep.submit(spec, _dec_tag(params["tag"]))
        return {"rid": int(rid)}, False
    if method == "step":
        rep.step()
        return None, False
    if method == "poll":
        return encode_poll(rep.poll()), False
    if method == "health":
        rep.health()
        return None, False
    if method == "progress":
        return [int(x) for x in rep.progress()], False
    if method == "signals":
        return {"capacity": int(rep.capacity), "load": int(rep.load),
                "free_slots": int(rep.free_slots)}, False
    if method == "prefix_probe":
        return int(rep.prefix_probe(
            onp.asarray(params["prompt"], dtype=onp.int32))), False
    if method == "cancel":
        return bool(rep.cancel(_dec_tag(params["tag"]))), False
    if method == "stats":
        return rep.stats(), False
    if method == "adopt":
        # hot-swap: the path names a file on the shared (same-host)
        # filesystem; verification/staging happen engine-side so the
        # typed failure contract is identical to in-process adoption
        return int(rep.adopt(params["checkpoint"])), False
    if method == "rollback":
        return int(rep.rollback()), False
    if method == "drain":
        tags = rep.drain()
        st = rep.stats()
        return {"tags": [_enc_tag(t) for t in tags],
                "blocks_in_use": int(st.get("blocks_in_use", 0)),
                "pinned_blocks": int(st.get("pinned_blocks", 0))}, False
    if method == "shutdown":
        # graceful exit: flush the in-flight cursors — one final poll
        # hands every token decoded since the last poll back to the
        # parent before the process leaves
        final = encode_poll(rep.poll())
        st = rep.stats()
        return {"final": final,
                "blocks_in_use": int(st.get("blocks_in_use", 0)),
                "pinned_blocks": int(st.get("pinned_blocks", 0))}, True
    raise ValueError("unknown RPC method %r" % (method,))


def main(argv=None) -> int:
    raw_in = sys.stdin.buffer
    raw_out = sys.stdout.buffer
    # stray prints (libraries, debug code) must never corrupt framing
    sys.stdout = sys.stderr

    init_buf = read_frame(raw_in)
    if init_buf is None:
        return 1
    init = json.loads(init_buf.decode())
    try:
        from ..observability.trace import get_tracer
        factory = resolve_factory(init["factory"])
        engine = factory(**(init.get("kwargs") or {}))
        from .transport import InProcessReplica
        rep = InProcessReplica(engine, init.get("replica_id", "r0"))
        dumps, loads = make_codec(init.get("codec", "json"))
    except BaseException as exc:  # noqa: BLE001 — the parent needs the
        # real reason its worker could not come up (its TransportError
        # quotes it)
        write_frame(raw_out, json.dumps(
            {"ok": False, "error": marshal_error(exc)}).encode())
        return 1
    write_frame(raw_out, json.dumps(
        {"ok": True, "pid": os.getpid(),
         "capacity": int(rep.capacity)}).encode())

    tracer = get_tracer()
    ev_cursor = 0
    served = 0
    while True:
        buf = read_frame(raw_in)
        if buf is None:
            break                      # parent gone: exit quietly
        req = loads(buf)
        served += 1
        # tracing follows the PARENT's tracer state, frame by frame: a
        # scoped ``tracing()`` block entered after this worker spawned
        # still gets the worker-side timeline
        want_trace = bool(req.get("trace"))
        if want_trace and not tracer.enabled:
            tracer.enable(reset=True)
            ev_cursor = 0
        elif not want_trace and tracer.enabled:
            tracer.disable()
        shutdown = False
        try:
            result, shutdown = _dispatch(rep, req.get("method"),
                                         req.get("params") or {})
            resp = {"id": req.get("id"), "ok": True, "result": result,
                    "served": served}
        except BaseException as exc:  # noqa: BLE001 — marshal, never die
            resp = {"id": req.get("id"), "ok": False,
                    "error": marshal_error(exc), "served": served}
        if tracer.enabled:
            evs = tracer.events()
            # tick and noise are stripped: the parent re-emits under
            # ITS deterministic counter clock
            resp["events"] = [[e.etype, e.rid, e.phase, e.fields]
                              for e in evs[ev_cursor:]]
            ev_cursor = len(evs)
        try:
            write_frame(raw_out, dumps(resp))
        except (BrokenPipeError, OSError):
            break
        if shutdown:
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
