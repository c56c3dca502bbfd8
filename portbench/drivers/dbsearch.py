"""A closed-loop bulk `search` of structures against a resident pt DB.

The DB is `db_rows` Foldclass embeddings (float32, as a pt DB stores them)
with target lengths, searched in the configuration's storage precision
with the pt path's length channel (mincov) and the mincos filter. The
Foldclass network runs at its published widths with weights made from the
seed, handed to the program and to the reference alike.

Queries are synthetic helical backbones (CA traces). Their lengths are
the same set in every call and every seed: `batch` quantiles of a
log-normal (median, sigma) clipped to the configuration's range, so a
call's work does not depend on the seed. A pool holds `copies` structures
of each length; a call takes one of each, chosen from the seed, in a
random rigid pose. Each pool structure has `planted` DB rows near its
reference embedding (cosines uniform in `planted_cos`), of lengths that
pass the coverage test but for `planted_fail` of them, so hits survive
the mincos filter and the length channel has work.

A call is `pipeline.dbsearch.run_dbsearch` with the resident
`SearchEngine`, the loaded `FoldClassNet` and `skip_tmalign=True`.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np
import torch

from portbench.compare import hit_lists, id_gap, rank_gap
from portbench.core import nospan
from portbench.reference import foldclass as ref_fc
from portbench.synthetic import helical_backbone, rotation


def slot_lengths(cfg: dict, n: int) -> list[int]:
    """The n query lengths of a call: quantiles (j + 0.5) / n of the
    configuration's log-normal, rounded and clipped."""
    lo, hi = cfg["length_clip"]
    nd = NormalDist()
    return [int(min(max(round(cfg["length_median"] * math.exp(
        cfg["length_sigma"] * nd.inv_cdf((j + 0.5) / n))), lo), hi)) for j in range(n)]


class Driver:
    """The system under test for one run: the DB, the engine over it, the
    network, and the query pool."""

    CONTROLS = ("tf32_embedder", "int8_scan")

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from merizo_search_tpu_torch.db.codecs import FlatDB
        from merizo_search_tpu_torch.models.foldclass import FoldClassNet
        from merizo_search_tpu_torch.pipeline import dbsearch
        from merizo_search_tpu_torch.search.engine import SearchEngine
        self.dbsearch = dbsearch
        self.SearchEngine, self.FoldClassNet = SearchEngine, FoldClassNet
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.k = int(traffic["k"])
        self.queries_per_call = int(traffic["batch"])
        self.lengths = slot_lengths(cfg, self.queries_per_call)
        self.seqs = {n: "A" * n for n in set(self.lengths)}
        rng = np.random.default_rng([seed, 1])
        gen = torch.Generator(device=device).manual_seed(seed)
        self.weights = ref_fc.seeded_weights(seed, device)
        copies = int(traffic["copies"])
        self.pool = [[helical_backbone(rng, n)[:, 1].astype(np.float32) for _ in range(copies)]
                     for n in self.lengths]
        self.rows, self.tlen = self._make_db(rng, gen)
        seqs = {int(t): "A" * int(t) for t in np.unique(self.tlen)}
        entries = [(f"d{i}", None, seqs[t]) for i, t in enumerate(self.tlen.tolist())]
        self.db = FlatDB.from_arrays(self.rows, entries)
        self.engine = SearchEngine(self.db, cfg["precision"], device)
        self.model = self._program_model()
        self.call(0, None)                   # warm: residency and the call's buckets

    def _program_model(self):
        model = self.FoldClassNet().to(self.device)
        missing = model.load_state_dict(self.weights, strict=False)
        if missing.missing_keys != ["posenc_as.pe"] or missing.unexpected_keys:
            raise RuntimeError(f"weights do not fit FoldClassNet: {missing}")
        return model.eval()

    @torch.no_grad()
    def _make_db(self, rng, gen):
        """DB rows [N, 128] float32 (Gaussian, with the planted rows) and
        target lengths [N], on the host."""
        cfg, tr, dev = self.cfg, self.traffic, self.device
        n = cfg["db_rows"]
        rows = torch.randn((n, cfg["dim"]), generator=gen, device=dev)
        tlen = torch.exp(math.log(cfg["length_median"]) + cfg["length_sigma"]
                         * torch.randn(n, generator=gen, device=dev))
        tlen = tlen.round().clamp(*cfg["length_clip"])
        emb = torch.cat([ref_fc.embed(self.weights, torch.from_numpy(np.stack(s)).to(dev))
                         for s in self.pool])                              # [slots*copies, D]
        emb /= torch.linalg.vector_norm(emb, dim=1, keepdim=True)
        qlen = torch.tensor([n_ for n_ in self.lengths for _ in range(tr["copies"])],
                            dtype=torch.float32, device=dev)
        p = int(tr["planted"])
        at = torch.randperm(n, generator=gen, device=dev)[:emb.shape[0] * p].view(-1, p)
        for j in range(p):
            z = torch.randn(emb.shape, generator=gen, device=dev)
            z -= (z * emb).sum(1, keepdim=True) * emb
            z /= torch.linalg.vector_norm(z, dim=1, keepdim=True)
            lo, hi = tr["planted_cos"]
            c = lo + (hi - lo) * torch.rand((emb.shape[0], 1), generator=gen, device=dev)
            rows[at[:, j]] = c * emb + torch.sqrt(1 - c * c) * z
            # coverage: pass is tlen * mincov <= qlen; the last planted_fail fail it
            fail = j >= p - int(tr["planted_fail"])
            f = (torch.rand(emb.shape[0], generator=gen, device=dev)
                 * (1.0 if fail else 0.9) + (1.5 if fail else 0.5))
            tlen[at[:, j]] = (qlen * f).round().clamp(min=cfg["length_clip"][0])
        return rows.cpu().numpy(), tlen.cpu().numpy().astype(np.int64)

    def inputs(self, i: int):
        """Call i's queries: one pool structure of each length in a rigid
        pose, all drawn from the seed and i."""
        rng = np.random.default_rng([self.seed, 5, i + 1])
        pick = rng.integers(0, self.traffic["copies"], len(self.lengths))
        rot, shift = rotation(rng), rng.normal(0.0, 20.0, 3)
        return [{"coords": (self.pool[j][c] @ rot.T + shift).astype(np.float32),
                 "seq": self.seqs[n], "name": f"q{i}_{j}"}
                for j, (n, c) in enumerate(zip(self.lengths, pick))]

    def call(self, i: int, span):
        span = span or nospan
        with span("prep"):
            queries = self.inputs(i)
        with span("search"):
            results, _ = self.dbsearch.run_dbsearch(
                queries, None, topk=self.k, mincos=self.cfg["mincos"],
                mincov=self.cfg["mincov"], inputs_are_ca=True, skip_tmalign=True,
                model=self.model, engine=self.engine)
        with span("assemble"):
            return self._table(results)

    def _table(self, results):
        vals = np.full((len(results), self.k), -np.inf, np.float32)
        ids = np.full((len(results), self.k), -1, np.int64)
        for qi, hits in enumerate(results):
            for rank, h in hits.items():
                vals[qi, rank], ids[qi, rank] = h["score"], h["dbindex"]
        return vals, ids

    # -- the check ------------------------------------------------------------

    def sample(self, kept: list, seed: int) -> list:
        """(call, answer, query slots) of the check: the longest query of
        each kept call and `per_call` - 1 others drawn from the seed."""
        rng = np.random.default_rng([seed, 11])
        m = int(self.traffic["check"]["per_call"])
        last = len(self.lengths) - 1
        return [(i, ans, np.sort(np.append(rng.choice(last, m - 1, replace=False), last)))
                for i, ans in kept]

    def _queries(self, picks):
        out = []
        for i, _, sel in picks:
            q = self.inputs(i)
            out += [q[j] for j in sel]
        return out

    def answers(self, picks):
        return (np.concatenate([ans[0][sel] for _, ans, sel in picks]),
                np.concatenate([ans[1][sel] for _, ans, sel in picks]))

    def _ref_rows(self):
        """The DB as the reference scans it: unit rows rounded to bf16, on
        the card, and the target lengths."""
        from portbench.reference import topk as ref
        chunk = 1 << 18
        rows = torch.empty((len(self.rows), self.cfg["dim"]), dtype=torch.bfloat16,
                           device=self.device)
        for c0 in range(0, len(self.rows), chunk):
            rows[c0:c0 + chunk] = torch.from_numpy(
                ref.normalize_rows(self.rows[c0:c0 + chunk])).to(self.device).to(torch.bfloat16)
        return rows, torch.from_numpy(self.tlen.astype(np.float32)).to(self.device)

    def _ref_search(self, queries, rows, tlen, tf32: bool = False):
        from portbench.reference import topk as ref
        emb = torch.cat([ref_fc.embed(self.weights, torch.from_numpy(q["coords"])[None]
                                      .to(self.device), tf32=tf32) for q in queries])
        q = ref.normalize_rows(emb.cpu().numpy())
        qlen = np.array([len(x["seq"]) for x in queries], np.float32)
        vals, ids = ref.bf16_topk(q, rows, tlen, qlen, self.cfg["mincov"], self.k)
        return q, qlen, vals, ids

    def reference(self, picks) -> dict:
        """The plain search of the sampled queries: the frozen Foldclass
        forward in float32, the exact bf16 top-k with the coverage mask."""
        rows, tlen = self._ref_rows()
        q, qlen, vals, ids = self._ref_search(self._queries(picks), rows, tlen)
        return {"q": q, "qlen": qlen, "vals": vals, "ids": ids, "rows": rows, "tlen": tlen}

    def control(self, picks, name: str):
        """A lower-precision control in the program's place: the reference
        with its embedder in TF32, or the program's own int8 scan path."""
        queries = self._queries(picks)
        if name == "tf32_embedder":
            rows, tlen = self._ref_rows()
            _, _, vals, ids = self._ref_search(queries, rows, tlen, tf32=True)
            hit = vals >= self.cfg["mincos"]
            return np.where(hit, vals, -np.inf).astype(np.float32), np.where(hit, ids, -1)
        engine = self.SearchEngine(self.db, "int8", self.device)
        results, _ = self.dbsearch.run_dbsearch(
            queries, None, topk=self.k, mincos=self.cfg["mincos"], mincov=self.cfg["mincov"],
            inputs_are_ca=True, skip_tmalign=True, model=self._program_model(), engine=engine)
        return self._table(results)

    def compare(self, refr: dict, answers) -> dict:
        """`score_gap`: the widest gap between the program's hit list and the
        reference's (scores >= mincos, rank by rank, a missing hit read as
        mincos); `id_gap`: the widest gap between a hit's score and the
        reference's score of its id (inf where the length channel masks
        it, or for an id twice in one list). Each gap is less the slack of
        the query's bf16 roundings that its float32 value leaves open
        (`rounding_tol`, reference.topk.bf16_ambiguity)."""
        from portbench.reference import topk as ref
        vals, ids = answers
        floor = self.cfg["mincos"]
        amb = ref.bf16_ambiguity(refr["q"], float(self.traffic["rounding_tol"]))
        exact = ref.bf16_scores_of(refr["q"], refr["rows"], refr["tlen"], refr["qlen"],
                                   self.cfg["mincov"], ids)
        slack = ref.bf16_slack(amb, refr["rows"], ids)
        # the r-th best moves by at most the largest slack of a row in either list
        per_query = np.maximum(slack.max(1), ref.bf16_slack(amb, refr["rows"], refr["ids"]).max(1))
        return {"score_gap": rank_gap(hit_lists(vals, floor, self.k),
                                      hit_lists(refr["vals"], floor, self.k), per_query),
                "id_gap": id_gap(vals, ids, exact, slack)}

    def release(self) -> None:
        """Free the program's state: the resident DB and the network."""
        self.engine = self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def least_call_s(self) -> float:
        """The least time of one call's work: the Foldclass forward over the
        call's lengths at the f32 peak (all pairs, published widths), then
        the scan's bytes (the bf16 rows and lengths read once)."""
        from portbench.peaks import HBM_BPS, PEAK_OPS, foldclass_flops
        scan = self.cfg["db_rows"] * (self.cfg["dim"] * 2 + 4)
        return foldclass_flops(self.lengths) / PEAK_OPS["f32"] + scan / HBM_BPS
