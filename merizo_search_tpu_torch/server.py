"""Persistent search server of the port.

The reference is CLI-only: every search pays the DB load and the model init
again. This server loads the database onto the card once (or streams it,
past the device budget), keeps the Foldclass and Merizo networks resident,
and answers queries over HTTP: the JAX package's server, with its
endpoints, limits, errors and JSON.

Endpoints (JSON in/out):
  GET  /healthz        -> {"status": "ok", "db_size": N, "mode": ...}
  GET  /stats          -> accumulated phase timings and the kernels' launch counts
  POST /search         -> body {"pdb": "<PDB text>", "chain": "A", "k": 10,
                                "mincos": 0.5, "mintm": 0.5, "mincov": 0.7,
                                "fastmode": false, "skip_tmalign": false}
                          or {"coords": [[x,y,z],...], "seq": "..."}
                          -> {"hits": [{target, emb_score, q_tm, ...}, ...]}
  POST /easy-search    -> body {"pdb": ..., "chain": ..., "k": ...}
                          -> {"ndom": n, "domains": [...], "hits_per_domain": [...]}

Run: python -m merizo_search_tpu_torch.cli serve <db_name> [--port 8086]
[--precision bf16] [-d cuda|cpu] [--mesh N] ...

Concurrency: requests are handled on a thread pool, and concurrent /search
requests with the same options are micro-batched into one scan (the scan is
bandwidth-bound, so a 64-query batch costs little more than one query): see
MicroBatcher. /easy-search runs on its handler thread, beside the batcher's.
Both send work to the card; the engine's lazy builds are under its lock.
/stats gives an operator the spans' totals ("phase_timings": each name's
seconds, self seconds and calls, e.g. "search", "search.prepare",
"search.copy_back") and the kernels' launch counters ("counters", e.g.
"blockmax.launches", "gather.launches"), counted under utils/profiling's
lock from every thread.

Unlike the JAX server, a warm-up that fails ends the boot: a kernel that
does not build or launch must not hide behind a server that answers.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import tempfile
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

logger = logging.getLogger(__name__)


class MicroBatcher:
    """Dynamic request batching: concurrent submissions with the same search
    options coalesce into one batched engine dispatch.

    The flat scan is bandwidth bound, so scanning for 64 queries costs
    little more than for one: under concurrent load this multiplies the
    server's throughput by the batch size reached. A submission waits at
    most `linger_ms` for co-travellers."""

    def __init__(self, fn, max_batch: int = 64, linger_ms: float = 4.0):
        self.fn = fn                      # fn(key, [item]) -> [result]
        self.queue: queue.Queue = queue.Queue()
        self.max_batch = max(1, max_batch)
        self.linger = max(0.0, linger_ms) / 1e3
        t = threading.Thread(target=self._loop, daemon=True, name="search-microbatcher")
        t.start()

    def submit(self, key, item) -> Future:
        fut: Future = Future()
        self.queue.put((key, item, fut))
        return fut

    def _loop(self):
        carry = None  # an options-mismatched request, held as the NEXT batch's
        #               seed (re-queuing it behind newer arrivals could defer
        #               a minority options key indefinitely under load)
        while True:
            key, item, fut = carry if carry is not None else self.queue.get()
            carry = None
            batch = [(item, fut)]
            deadline = time.time() + self.linger
            while len(batch) < self.max_batch:
                timeout = deadline - time.time()
                if timeout <= 0:
                    break
                try:
                    k2, i2, f2 = self.queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if k2 != key:  # different options: seed the next batch
                    carry = (k2, i2, f2)
                    break
                batch.append((i2, f2))
            try:
                results = self.fn(key, [b[0] for b in batch])
                for (_, f), r in zip(batch, results):
                    f.set_result(r)
            except BaseException as e:  # noqa: BLE001  (handed to the waiting request)
                if len(batch) == 1:
                    fut.set_exception(e)
                    continue
                # one bad query must not fail its co-batched travellers:
                # retry each request alone so only the culprit(s) error
                for it, f in batch:
                    try:
                        f.set_result(self.fn(key, [it])[0])
                    except BaseException as e2:  # noqa: BLE001
                        f.set_exception(e2)


def _warmup_backbone_pdb(coords: np.ndarray) -> str:
    """PDB text of a complete N/CA/C/O backbone around the CA trace `coords`
    (the segmenter builds frames from N, CA and C, and rejects CA-only
    chains)."""
    lines, serial = [], 1
    for i, ca in enumerate(coords):
        for atom, off in (("N", -0.7), ("CA", 0.0), ("C", 0.7), ("O", 1.2)):
            x, y, z = (float(v) + off for v in ca)
            lines.append(f"ATOM  {serial:5d} {atom:<4s} ALA A{i + 1:4d}    "
                         f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00           {atom[0]}")
            serial += 1
    return "\n".join(lines) + "\nTER\nEND\n"


class SearchService:
    """Resident models + database + search pipeline on one device; with a
    `mesh` (device.make_mesh) the database is sharded over its devices, and
    the models stay on `device`, as in the JAX service."""

    MAX_K = 1000
    MAX_QUERY_RES = 20000
    # request bodies are buffered in RAM before parsing; full-backbone PDBs
    # run ~80 B/atom * 4 atoms/residue, so 16 MB comfortably covers the
    # residue cap while bounding what one client can make the server hold
    MAX_BODY_BYTES = 16 * 1024 * 1024

    def __init__(self, db_name: str, precision: str = "bf16",
                 weights: str | None = None, merizo_weights: str | None = None,
                 tmalign_backend: str = "auto", search_index: str = "flat",
                 nprobe: int = 32, nlist: int = 0, ivf_rerank: bool = False,
                 max_batch: int = 64, batch_window_ms: float = 4.0,
                 device: str = "cuda", mesh=None):
        from .db.codecs import FlatDB
        from .device import resolve_device
        from .models.merizo.network import load_merizo_params
        from .pipeline.embed import load_foldclass_params
        from .search.engine import SearchEngine

        if tmalign_backend not in ("auto", "native", "tpu"):
            raise ValueError(f"unknown tmalign backend {tmalign_backend!r}")
        self.device = resolve_device(device)
        self.db = FlatDB.open(db_name)
        self.engine = SearchEngine(self.db, dtype=precision, device=self.device,
                                   index=search_index, ivf_nlist=nlist,
                                   ivf_nprobe=nprobe, ivf_rerank=ivf_rerank, mesh=mesh)
        self.fc_model = load_foldclass_params(weights, self.device)
        self.mz_model = load_merizo_params(merizo_weights, self.device)
        self.tmalign_backend = tmalign_backend
        self.started = time.time()
        self.n_requests = 0
        self.n_batches = 0
        self._lock = threading.Lock()
        self._batcher = (MicroBatcher(self._run_search_batch, max_batch, batch_window_ms)
                         if max_batch > 1 else None)
        if self.engine.mode == "device":
            self.engine._load_resident()   # pay DB residency once, at boot
        self._warmup()
        logger.info("service ready: %d entries (%s mode) on %s", self.db.size,
                    self.engine.mode, ", ".join(map(str, self.engine.devices)))

    def _warmup(self):
        """Run each path once at boot, as the JAX server does: a skip-TM-align
        search in device mode (the embedder alone in stream mode, where a
        search would scan the whole on-disk DB), and the segmenter on a
        64-residue synthetic backbone; with the device aligner, one pair
        aligned too. Any failure propagates: the boot fails."""
        from .pipeline.dbsearch import run_dbsearch
        from .pipeline.embed import embed_structures
        from .segment.pipeline import segment_structure

        rng = np.random.default_rng(0)
        dummy = {"coords": np.cumsum(rng.normal(size=(64, 3)) * 1.8,
                                     axis=0).astype(np.float32),
                 "seq": "A" * 64, "name": "warmup"}
        t0 = time.time()
        if self.engine.mode == "device":
            run_dbsearch([dummy], db_name=None, engine=self.engine, model=self.fc_model,
                         topk=1, skip_tmalign=True, inputs_are_ca=True, device=self.device)
        else:
            embed_structures(self.fc_model, [dummy["coords"]])
        if self.tmalign_backend == "tpu":
            from .align.tmalign import run_tmalign_pair

            run_tmalign_pair(dummy, dummy, device=self.device)
        with tempfile.TemporaryDirectory() as td:
            p = os.path.join(td, "warmup.pdb")
            with open(p, "w") as fh:
                fh.write(_warmup_backbone_pdb(dummy["coords"]))
            segment_structure(self.mz_model, p, chain="A")
        logger.info("warm-up finished in %.1fs", time.time() - t0)

    # -- request handling ---------------------------------------------------
    def _clamp_k(self, body: dict) -> int:
        """Client-controlled k is bounded: an absurd k would allocate k-wide
        result arrays and exhaust the shared service's memory."""
        try:
            k = int(body.get("k", 1))
        except (TypeError, ValueError):
            raise ValueError("'k' must be an integer")
        if not 1 <= k <= self.MAX_K:
            raise ValueError(f"'k' must be in [1, {self.MAX_K}]")
        return k

    def _query_struct(self, body: dict) -> dict:
        from .io.pdb import read_ca

        if "coords" in body:
            coords = np.asarray(body["coords"], np.float32)
            if coords.ndim != 2 or coords.shape[1] != 3:
                raise ValueError("'coords' must be [N, 3]")
            if len(coords) > self.MAX_QUERY_RES:
                raise ValueError(f"query too large (> {self.MAX_QUERY_RES} residues)")
            seq = body.get("seq", "A" * len(coords))
            return {"coords": coords, "seq": seq, "name": body.get("name", "query")}
        if "pdb" in body:
            if len(body["pdb"]) > 64 * self.MAX_QUERY_RES:
                raise ValueError("PDB body too large")
            with tempfile.NamedTemporaryFile("w", suffix=".pdb") as fh:
                fh.write(body["pdb"])
                fh.flush()
                d = read_ca(fh.name, body.get("chain", "A"))
            d["name"] = body.get("name", "query")
            return d
        raise ValueError("request needs 'pdb' or 'coords'")

    @staticmethod
    def _opt_float(body: dict, name: str, default: float) -> float:
        v = body.get(name, default)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ValueError(f"'{name}' must be a number")
        if not 0.0 <= float(v) <= 1.0:
            raise ValueError(f"'{name}' must be in [0, 1]")
        return float(v)

    @staticmethod
    def _opt_bool(body: dict, name: str) -> bool:
        v = body.get(name, False)
        if not isinstance(v, bool):
            # bool("false") is True: a string here would silently flip the flag
            raise ValueError(f"'{name}' must be a JSON boolean")
        return v

    def _opts_key(self, body: dict) -> tuple:
        return (self._clamp_k(body),
                self._opt_float(body, "mincos", 0.5),
                self._opt_float(body, "mintm", 0.5),
                self._opt_float(body, "mincov", 0.7),
                self._opt_bool(body, "fastmode"),
                self._opt_bool(body, "skip_tmalign"))

    def _dbsearch(self, queries: list[dict], key: tuple):
        from .pipeline.dbsearch import run_dbsearch

        k, mincos, mintm, mincov, fastmode, skip_tmalign = key
        results, _ = run_dbsearch(
            queries, db_name=None, engine=self.engine, model=self.fc_model,
            topk=k, mincos=mincos, mintm=mintm, mincov=mincov,
            fastmode=fastmode, skip_tmalign=skip_tmalign, inputs_are_ca=True,
            tmalign_backend=self.tmalign_backend, device=self.device)
        return [[_hit_json(rank, h) for rank, h in r.items()] for r in results]

    def _run_search_batch(self, key: tuple, queries: list[dict]) -> list[dict]:
        hits = self._dbsearch(queries, key)
        with self._lock:
            self.n_batches += 1
        return [{"hits": h} for h in hits]

    def search(self, body: dict) -> dict:
        q = self._query_struct(body)
        key = self._opts_key(body)
        if self._batcher is not None:
            out = self._batcher.submit(key, q).result()
        else:
            out = self._run_search_batch(key, [q])[0]
        with self._lock:
            self.n_requests += 1
        return out

    def easy_search(self, body: dict) -> dict:
        from .segment.outputs import domains_as_list
        from .segment.pipeline import segment_structure

        if "pdb" not in body:
            raise ValueError("easy-search needs 'pdb'")
        if len(body["pdb"]) > 64 * self.MAX_QUERY_RES:
            raise ValueError("PDB body too large")
        key = self._opts_key(body)
        with tempfile.NamedTemporaryFile("w", suffix=".pdb") as fh:
            fh.write(body["pdb"])
            fh.flush()
            f = segment_structure(self.mz_model, fh.name, chain=body.get("chain", "A"),
                                  iterate=self._opt_bool(body, "iterate"))
        domains = domains_as_list(f, body.get("name", "query"))
        out = {"ndom": int(f["ndom"]),
               "domains": [{"name": d["name"], "dom_str": d["dom_str"],
                            "dom_conf": d["dom_conf"], "dom_plddt": d["dom_plddt"],
                            "nres": int(len(d["seq"]))} for d in domains],
               "hits_per_domain": self._dbsearch(domains, key) if domains else []}
        with self._lock:
            self.n_requests += 1
        return out

    def stats(self) -> dict:
        from .utils import profiling

        return {
            "db_size": self.db.size,
            "mode": self.engine.mode,
            "uptime_s": round(time.time() - self.started, 1),
            "requests": self.n_requests,
            "search_batches": self.n_batches,
            "phase_timings": {k: {"seconds": round(t.seconds, 4),
                                  "self_seconds": round(t.self_s, 4), "calls": t.calls}
                              for k, t in profiling.timings().items()},
            "counters": profiling.counters(),
        }


def _hit_json(rank, h) -> dict:
    tm = h.get("tmalign_output") or {}
    return {
        "rank": int(rank),
        "target": h["target"],
        "emb_score": round(float(h["score"]), 4),
        "q_len": int(h["q_len"]),
        "t_len": int(h["t_len"]),
        "ali_len": tm.get("len_ali"),
        "seq_id": round(tm["seq_id"], 4) if tm else None,
        "q_tm": round(tm["qtm"], 4) if tm else None,
        "t_tm": round(tm["ttm"], 4) if tm else None,
        "rmsd": round(tm["rmsd"], 2) if tm else None,
        "metadata": h.get("metadata"),
    }


def make_handler(service: SearchService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.info("%s " + fmt, self.address_string(), *args)

        def _reply(self, code: int, obj: dict):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok", "db_size": service.db.size,
                                  "mode": service.engine.mode})
            elif self.path == "/stats":
                self._reply(200, service.stats())
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > service.MAX_BODY_BYTES:
                    # reject BEFORE buffering: rfile.read(n) would hold the
                    # whole declared length in RAM ahead of any size check
                    self._reply(413, {"error": "request body too large "
                                      f"(> {service.MAX_BODY_BYTES} bytes)"})
                    return
                body = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/search":
                    self._reply(200, service.search(body))
                elif self.path == "/easy-search":
                    self._reply(200, service.easy_search(body))
                else:
                    self._reply(404, {"error": "unknown path"})
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # keep the server alive on bad inputs
                logger.exception("request failed")
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(db_name: str, host: str = "127.0.0.1", port: int = 8086, **kw):
    """Blocking entry point: build the service, then serve until interrupted."""
    service = SearchService(db_name, **kw)
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    logger.info("serving on http://%s:%d (POST /search, /easy-search)", host,
                httpd.server_address[1])
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        httpd.server_close()
    return httpd
