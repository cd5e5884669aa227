"""Serve a frozen exported predictor: request -> K-sample rollout
(counterpart of ``mmtraj/serve.py``, with the same protocol).

``PredictServer`` wraps an artifact of ``mmtraj_torch.export`` and pads each
request up to the artifact's static (batch, n_agents), whose shapes were fixed
at export, then slices the response back to the request's true size, so
callers send exactly the windows they have.  ``serve_lines`` is a JSON-lines
loop over any text streams (stdin/stdout under ``python -m mmtraj_torch.cli
serve``), one request per line:

    {"xy": [N][T_obs][2] or [B][N][T_obs][2], "mask": [N]|[B][N] (optional),
     "seed": int (optional), "encoding": "json"|"b64-npy" (optional)}
    -> {"pred": [K][B][N][T_pred][2], "k": K}   (B/N as sent; a singleton batch
                                                 echoed without the B axis)

``"xy_b64_npy"`` (base64 of an ``np.save`` buffer, the same [N][T][2] or
[B][N][T][2] shapes, any float dtype) may replace ``"xy"``.  With
``"encoding": "b64-npy"`` the response carries the prediction as a base64
.npy payload (``{"pred_b64_npy": ..., "shape": [...], "k": K}``) instead of
nested JSON lists; ``np.load`` decodes it losslessly.

**Request aggregation** (``aggregate > 1``, ``cli serve --aggregate N``):
consecutive single-window requests with the same seed are collected for up
to ``window_ms`` ms (or until N are pending or the capacity is reached) and
answered with one device call.  The contract is client-side batching: each
response equals what the caller would get by sending the group as one
batched request (a window's samples depend on its slot in the call, as in
any batched request).  Responses come back in request order; a malformed
or non-groupable request flushes the pending group first.

Malformed or out-of-capacity requests get ``{"error": ...}`` on their line
and the loop continues.

**Pipelined host path** (default on): the loop only dispatches each call (a
CUDA launch returns before the card finishes); the device-to-host copy
(``.cpu()``, which waits for the result), the response encoding and the
write run on a writer thread behind a bounded FIFO of 8, so the loop parses
and dispatches request k+1 while request k is still on the card.  The
emitted bytes equal the serial path's.  A failure of the copy or the
encoding is answered as ``{"error": ...}`` on that request's line; only a
failure to write the response stream ends the loop, surfacing at the next
emit or at the end, whose puts re-check the writer's health so that a dead
writer never deadlocks the loop.

The artifact's program runs eagerly; each call draws its stream on the
device (``export.draw_stream``) and allocates its output anew, so a result
handed to the writer thread is never overwritten.
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional

import numpy as np
import torch


def to_host(out) -> np.ndarray:
    """The device result as a numpy array (waits for the card)."""
    return out.cpu().numpy()


class PredictServer:
    """Wraps an exported predictor artifact; pads requests to its static
    shapes and slices responses back.

    Attributes (read from the program's input and output shapes, not trusted
    from the caller): ``batch``, ``n_agents``, ``obs_len``, ``pred_len``,
    ``k``; ``device`` is the artifact's.
    """

    def __init__(self, artifact_path: str):
        from mmtraj_torch.export import input_shapes, load_exported

        program, meta = load_exported(artifact_path)
        self.path = artifact_path
        xy_shape, _, stream_shape, _ = input_shapes(program)
        out_node = next(n for n in program.graph.nodes if n.op == "output")
        out_shape = tuple(out_node.args[0][0].meta["val"].shape)
        self.batch, self.n_agents, self.obs_len = xy_shape[:3]
        self.k, self.pred_len = out_shape[0], out_shape[3]
        self._rows, self._mixtures = stream_shape[0], stream_shape[3]
        self.device = torch.device(meta["device"])
        self._call = program.module()

    def check(self, xy: np.ndarray,
              mask: Optional[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
        """Validate a (B,N,obs_len,2) request against the artifact's static
        capacity; returns (xy_f32, mask_bool) with the default all-true mask
        materialized.  Raises ValueError with a one-line diagnosis."""
        xy = np.asarray(xy, np.float32)
        if xy.ndim != 4 or xy.shape[-1] != 2:
            raise ValueError(f"xy must be (B,N,{self.obs_len},2), got {xy.shape}")
        b, n, t = xy.shape[:3]
        if t != self.obs_len:
            raise ValueError(f"obs_len mismatch: artifact expects "
                             f"{self.obs_len} steps, got {t}")
        if b > self.batch or n > self.n_agents:
            raise ValueError(f"request ({b},{n}) exceeds artifact capacity "
                             f"({self.batch},{self.n_agents}); re-export with "
                             f"a larger --batch / n_max")
        if mask is None:
            mask = np.ones((b, n), bool)
        mask = np.asarray(mask, bool)
        if mask.shape != (b, n):
            raise ValueError(f"mask shape {mask.shape} != ({b},{n})")
        return xy, mask

    def predict_async(self, xy: np.ndarray,
                      mask: Optional[np.ndarray] = None,
                      seed: int = 0):
        """Validate, pad and dispatch only: returns (device_out, (b, n)), where
        ``device_out`` is the artifact's full (K, B_cap, N_cap, pred_len, 2)
        result on its device, possibly still being computed, and (b, n) the
        request's true size for the caller's ``to_host(device_out)[:, :b,
        :n]``."""
        from mmtraj_torch.export import draw_stream

        xy, mask = self.check(xy, mask)
        b, n = mask.shape
        xy_p = np.zeros((self.batch, self.n_agents, self.obs_len, 2), np.float32)
        xy_p[:b, :n] = xy
        mask_p = np.zeros((self.batch, self.n_agents), bool)
        mask_p[:b, :n] = mask
        gumbel, normal = draw_stream(self._rows, self.pred_len, self.n_agents,
                                     self._mixtures, seed, self.device)
        with torch.no_grad():
            out = self._call(torch.from_numpy(xy_p).to(self.device),
                             torch.from_numpy(mask_p).to(self.device), gumbel, normal)
        return out, (b, n)

    def predict(self, xy: np.ndarray, mask: Optional[np.ndarray] = None,
                seed: int = 0) -> np.ndarray:
        """xy (B,N,obs_len,2) -> (K,B,N,pred_len,2); B/N may be anything up
        to the artifact's static capacity (padded agents are dropped by the
        slice; padding never changes valid agents' outputs)."""
        out, (b, n) = self.predict_async(xy, mask, seed)
        return to_host(out)[:, :b, :n]


class BucketedPredictServer:
    """Routes each request to the smallest of several exported artifacts
    whose static (batch, n_agents) capacity holds it: a replica exports one
    checkpoint at graduated capacities (e.g. n_agents 16/32/64) and passes
    them all to ``cli serve --artifact a16 a32 a64``, so a 6-agent request
    runs at 16 agents, not 64.  All artifacts must agree on (k, obs_len,
    pred_len); capacity errors are judged against the combined capacity.
    Which artifact answers is part of the request's execution shape, so its
    sample stream depends on the routed capacity as a batched request's
    depends on its group; each response equals the same request sent
    straight to that artifact.
    """

    def __init__(self, artifact_paths):
        servers = [PredictServer(p) for p in artifact_paths]
        self.path = list(artifact_paths)
        if not servers:
            raise ValueError("no artifacts")
        heads = {(s.k, s.obs_len, s.pred_len) for s in servers}
        if len(heads) > 1:
            raise ValueError(
                f"artifacts disagree on (k, obs_len, pred_len): {heads}")
        # Route order: smallest n_agents first, then smallest batch.
        self._servers = sorted(servers,
                               key=lambda s: (s.n_agents, s.batch))
        self.batch = max(s.batch for s in servers)
        self.n_agents = max(s.n_agents for s in servers)
        self.obs_len = servers[0].obs_len
        self.k = servers[0].k
        self.pred_len = servers[0].pred_len

    def _route(self, b: int, n: int) -> PredictServer:
        for s in self._servers:
            if b <= s.batch and n <= s.n_agents:
                return s
        raise ValueError(
            f"request ({b},{n}) exceeds every artifact's capacity "
            f"(combined max ({self.batch},{self.n_agents})); re-export with "
            f"a larger --batch / n_max")

    def check(self, xy, mask):
        """Same validation contract as PredictServer.check, against the
        combined capacity (so the routed artifact always fits)."""
        xy = np.asarray(xy, np.float32)
        if xy.ndim != 4 or xy.shape[-1] != 2:
            raise ValueError(f"xy must be (B,N,{self.obs_len},2), got {xy.shape}")
        b, n, t = xy.shape[:3]
        if t != self.obs_len:
            raise ValueError(f"obs_len mismatch: artifact expects "
                             f"{self.obs_len} steps, got {t}")
        self._route(b, n)  # raises the capacity error if nothing fits
        if mask is None:
            mask = np.ones((b, n), bool)
        mask = np.asarray(mask, bool)
        if mask.shape != (b, n):
            raise ValueError(f"mask shape {mask.shape} != ({b},{n})")
        return xy, mask

    def predict_async(self, xy, mask=None, seed: int = 0):
        xy, mask = self.check(xy, mask)
        return self._route(*mask.shape).predict_async(xy, mask, seed)

    def predict(self, xy, mask=None, seed: int = 0):
        out, (b, n) = self.predict_async(xy, mask, seed)
        return to_host(out)[:, :b, :n]


def _parse_request(line: str, server: PredictServer) -> dict:
    """One JSON line -> validated request dict (raises on anything wrong)."""
    req = json.loads(line)
    if "xy_b64_npy" in req:
        # Binary input path, symmetric with the b64-npy response encoding:
        # base64 .npy decodes with less work than json.loads of the same
        # nested float lists, and the gap grows with N*T.
        import base64
        import io as _io

        if "xy" in req:
            raise ValueError("send exactly one of 'xy' | 'xy_b64_npy'")
        raw = np.load(_io.BytesIO(base64.b64decode(req["xy_b64_npy"])),
                      allow_pickle=False)
        if raw.ndim not in (3, 4):
            raise ValueError(f"xy_b64_npy must be [N][T][2] or [B][N][T][2], "
                             f"got shape {raw.shape}")
        xy = raw.astype(np.float32, copy=False)
    else:
        xy = np.asarray(req["xy"], np.float32)
    single = xy.ndim == 3  # [N][T][2]: echo back without a batch axis
    if single:
        xy = xy[None]
    mask = req.get("mask")
    if mask is not None:
        mask = np.asarray(mask, bool)
        if single:
            mask = mask[None]
    xy, mask = server.check(xy, mask)
    encoding = req.get("encoding", "json")
    if encoding not in ("json", "b64-npy"):
        raise ValueError(f"unknown encoding {encoding!r} (json | b64-npy)")
    return {"xy": xy, "mask": mask, "seed": int(req.get("seed", 0)),
            "single": single, "encoding": encoding}


def _encode_response(pred: np.ndarray, k: int, encoding: str) -> dict:
    if encoding == "b64-npy":
        import base64
        import io as _io

        buf = _io.BytesIO()
        np.save(buf, pred, allow_pickle=False)
        return {"pred_b64_npy": base64.b64encode(buf.getvalue()).decode(),
                "shape": list(pred.shape), "k": k}
    return {"pred": pred.tolist(), "k": k}


def serve_lines(artifact_path: str, in_stream: IO[str], out_stream: IO[str],
                log_stream: IO[str] = sys.stderr, aggregate: int = 1,
                window_ms: float = 5.0, stats_every: int = 0,
                pipeline_encode: bool = True) -> int:
    """JSON-lines request loop; returns the number of requests served OK.

    With ``aggregate > 1``, consecutive single-window same-seed requests are
    micro-batched into one device call (see the module docstring for the
    exact semantics); ``window_ms`` bounds how long the first request of a
    group waits for company.  With ``stats_every=N``, one operational line
    goes to ``log_stream`` every N answered requests: cumulative ok/err
    counts, requests/s since the previous line, and (when aggregating) the
    mean device-call group size over that interval.

    ``pipeline_encode`` (default on) moves the device-to-host copy, response
    encoding and writing to a dedicated writer thread behind a bounded FIFO,
    so the device loop never waits on the JSON/b64 encode of the previous
    response: that host stage overlaps the next device call.  Responses
    stay in request order (the
    FIFO is the order) and bytes are identical to the serial path; the
    flag exists only as an escape hatch for debugging.

    ``artifact_path`` may be a list of artifacts exported at graduated
    capacities — requests then route to the smallest one that fits
    (BucketedPredictServer).  Aggregated groups route by the group's
    (size, widest member), preserving the client-side-batching equivalence
    against the routed artifact.  ``artifact_path`` may also be a server
    loaded before (a benchmark keeps the load out of its timing).
    """
    if isinstance(artifact_path, (PredictServer, BucketedPredictServer)):
        server = artifact_path
    elif isinstance(artifact_path, (list, tuple)) and len(artifact_path) > 1:
        server = BucketedPredictServer(artifact_path)
    else:
        if isinstance(artifact_path, (list, tuple)):
            artifact_path = artifact_path[0]
        server = PredictServer(artifact_path)
    agg = max(1, min(int(aggregate), server.batch))
    print(f"serving {server.path}: capacity batch={server.batch} "
          f"n_agents={server.n_agents} obs_len={server.obs_len} "
          f"K={server.k}"
          + (f" aggregate={agg} window_ms={window_ms}" if agg > 1 else ""),
          file=log_stream, flush=True)
    # Main-thread cumulative counters (ok responses, successful device calls,
    # lines answered by those calls).  With the pipelined writer the main
    # loop dispatches ahead of what has been written, so every emitted
    # response carries a SNAPSHOT of these taken at emit time — the stats
    # lines then report exactly what the serial path would, regardless of
    # how far ahead the dispatch loop is.
    mt = {"ok": 0, "calls": 0, "lines": 0}
    st = {"err": 0, "answered": 0, "t": time.monotonic(),
          "last_answered": 0, "last_calls": 0, "last_lines": 0}

    def write_resp(resp: dict, snap: tuple) -> None:
        print(json.dumps(resp), file=out_stream, flush=True)
        st["answered"] += 1
        if "error" in resp:
            st["err"] += 1
        if stats_every and st["answered"] % stats_every == 0:
            now = time.monotonic()
            n = st["answered"] - st["last_answered"]
            qps = n / max(now - st["t"], 1e-9)
            line = (f"stats: answered={st['answered']} ok={snap[0]} "
                    f"err={st['err']} qps={qps:.1f}")
            d_calls = snap[1] - st["last_calls"]
            if agg > 1 and d_calls:
                # Lines answered by successful device calls over those calls —
                # error lines and failed groups count in neither term.
                line += f" mean_group={(snap[2] - st['last_lines']) / d_calls:.1f}"
            print(line, file=log_stream, flush=True)
            st["t"], st["last_answered"] = now, st["answered"]
            st["last_calls"], st["last_lines"] = snap[1], snap[2]

    if pipeline_encode:
        import queue as _queue
        import threading as _threading

        out_q: "_queue.Queue" = _queue.Queue(maxsize=8)  # backpressure
        _DONE = object()
        writer_err: list = []

        def _writer() -> None:
            while True:
                item = out_q.get()
                if item is _DONE:
                    return
                payload, snap = item
                try:
                    if callable(payload):
                        # Materializing the response pays the device wait +
                        # fetch + encode.  A failure HERE is a per-request
                        # problem (the serial path catches the equivalent
                        # blocking-predict failure inside answer_one's try),
                        # so it must answer {"error": ...} on this line, not
                        # kill the replica.  NB the dispatch loop already
                        # counted this request ok at dispatch time; the
                        # stats line's err counter (write_resp) still
                        # records it, so only the cumulative ok snapshot
                        # can over-count by in-flight fetch failures.
                        try:
                            resp = payload()
                        except Exception as e:  # noqa: BLE001
                            resp = {"error": f"{type(e).__name__}: {e}"}
                    else:
                        resp = payload
                    write_resp(resp, snap)
                except Exception as e:  # noqa: BLE001 — stream write died:
                    # nothing more can ever be answered, so THIS is the
                    # replica-fatal case.  Record it, then drain the FIFO so
                    # any emit() blocked on a full queue unblocks promptly
                    # (emit's timeout loop would also catch it; draining
                    # just makes the failure surface immediately).
                    writer_err.append(e)
                    try:
                        while True:
                            out_q.get_nowait()
                    except _queue.Empty:
                        pass
                    return

        writer = _threading.Thread(target=_writer, daemon=True)
        writer.start()

        def emit(resp_or_thunk) -> None:
            # Bounded-timeout put that re-checks the writer's health: a
            # blocking put against a full FIFO whose consumer has died would
            # hang the dispatch loop forever.  The 100 ms poll
            # costs nothing on the happy path (the put succeeds immediately
            # whenever the queue has room).
            item = (resp_or_thunk, (mt["ok"], mt["calls"], mt["lines"]))
            while True:
                if writer_err:
                    raise writer_err[0]
                try:
                    out_q.put(item, timeout=0.1)
                    return
                except _queue.Full:
                    continue

        def finish() -> None:
            while True:
                if writer_err:
                    raise writer_err[0]
                try:
                    out_q.put(_DONE, timeout=0.1)
                    break
                except _queue.Full:
                    continue
            writer.join()
            if writer_err:
                raise writer_err[0]
    else:
        def emit(resp_or_thunk) -> None:
            write_resp(resp_or_thunk() if callable(resp_or_thunk)
                       else resp_or_thunk,
                       (mt["ok"], mt["calls"], mt["lines"]))

        def finish() -> None:
            pass

    def _lazy_fetch(dev, b: int, n: int):
        """One shared, memoized device->host fetch for the request (or
        group) that produced ``dev``; thunks on the writer thread call it so
        the blocking fetch rides that thread, overlapped with the device
        loop's next dispatch.  Memoized so a group of G responses pays ONE
        fetch, exactly like the blocking path — and a fetch FAILURE is
        memoized too, so every member of a failed group answers its error
        line from the one attempt instead of re-blocking on a dead fetch."""
        box = [dev, None, None]  # [device buf, host result, fetch error]

        def get():
            if box[2] is not None:
                raise box[2]
            if box[1] is None:
                try:
                    box[1] = to_host(box[0])[:, :b, :n]
                except Exception as e:  # noqa: BLE001 — re-raised per caller
                    box[2] = e
                    box[0] = None
                    raise
                box[0] = None  # release the device buffer
            return box[1]

        return get

    def answer_one(r: dict) -> None:
        try:
            if pipeline_encode:
                # Dispatch only; the writer thread pays the device wait +
                # fetch + encode while this loop parses/dispatches the next
                # request.  A fetch-time device failure is caught on the
                # writer thread and answered {"error": ...} on this line,
                # matching the blocking path's per-request error contract.
                dev, (b, n) = server.predict_async(r["xy"], r["mask"],
                                                   r["seed"])
                get = _lazy_fetch(dev, b, n)

                def resp(get=get, single=r["single"], enc=r["encoding"]):
                    pred = get()
                    if single:
                        pred = pred[:, 0]
                    return _encode_response(pred, server.k, enc)
            else:
                pred = server.predict(r["xy"], r["mask"], r["seed"])
                if r["single"]:
                    pred = pred[:, 0]
                resp = lambda: _encode_response(pred, server.k, r["encoding"])  # noqa: E731
            mt["calls"] += 1
            mt["lines"] += 1
            mt["ok"] += 1
        except Exception as e:  # noqa: BLE001 — must not kill the loop
            resp = {"error": f"{type(e).__name__}: {e}"}
        emit(resp)

    if agg == 1:
        for line in in_stream:
            line = line.strip()
            if not line:
                continue
            try:
                r = _parse_request(line, server)
            except Exception as e:  # noqa: BLE001
                emit({"error": f"{type(e).__name__}: {e}"})
                continue
            answer_one(r)
        finish()
        return mt["ok"]

    import queue
    import threading

    q: "queue.Queue" = queue.Queue()
    _EOF = object()

    def reader() -> None:
        for line in in_stream:
            q.put(line)
        q.put(_EOF)

    threading.Thread(target=reader, daemon=True).start()

    pending: list[dict] = []
    deadline = 0.0

    def flush() -> None:
        """Answer every pending request with one device call (in order)."""
        if not pending:
            return
        group, n_g = pending[:], max(r["mask"].shape[1] for r in pending)
        pending.clear()
        xy_b = np.zeros((len(group), n_g, server.obs_len, 2), np.float32)
        mask_b = np.zeros((len(group), n_g), bool)
        for j, r in enumerate(group):
            n = r["mask"].shape[1]
            xy_b[j, :n] = r["xy"][0]
            mask_b[j, :n] = r["mask"][0]
        try:
            if pipeline_encode:
                dev, (b_g, _) = server.predict_async(xy_b, mask_b,
                                                     group[0]["seed"])
                get = _lazy_fetch(dev, b_g, n_g)
            else:
                pred = server.predict(xy_b, mask_b, group[0]["seed"])
                get = lambda: pred  # noqa: E731
            mt["calls"] += 1
            mt["lines"] += len(group)
        except Exception as e:  # noqa: BLE001
            for _ in group:
                emit({"error": f"{type(e).__name__}: {e}"})
            return
        if len(group) > 1:
            print(f"aggregated {len(group)} requests into one device call",
                  file=log_stream, flush=True)
        for j, r in enumerate(group):
            n = r["mask"].shape[1]
            mt["ok"] += 1
            emit(lambda get=get, j=j, n=n, enc=r["encoding"]:
                 _encode_response(get()[:, j, :n], server.k, enc))

    while True:
        timeout = max(0.0, deadline - time.monotonic()) if pending else None
        try:
            item = q.get(timeout=timeout)
        except queue.Empty:  # window expired with requests pending
            flush()
            continue
        if item is _EOF:
            flush()
            break
        line = item.strip()
        if not line:
            continue
        try:
            r = _parse_request(line, server)
        except Exception as e:  # noqa: BLE001
            flush()  # answers stay in request order
            emit({"error": f"{type(e).__name__}: {e}"})
            continue
        if pending and not (r["single"] and r["seed"] == pending[0]["seed"]):
            flush()
        if r["single"]:
            if not pending:
                deadline = time.monotonic() + window_ms / 1000.0
            pending.append(r)
            if len(pending) >= agg:
                flush()
        else:
            flush()
            answer_one(r)
    finish()
    return mt["ok"]
