"""A closed-loop batch scan of one card's shard of a mesh-sharded DB.

The DB of `db_rows` rows is laid out as the port's engine shards it over
`mesh_devices` cards: an equal run of whole 128-row blocks a card, this
card holding the rows of `shard_index` (the last run is ragged). The rows
are unit vectors quantised to int8 with one scale a 128-row block, as the
int8 sidecar of an mmap DB stores them, made on the card from the seed and
handed to the program in host memory, as the sidecar's reads hand them.

The program is a `SearchEngine` over those rows in int8: its own
residency puts them on the card (set-up), and a call is its public
`search` of one batch (normalise, quantise, scan in phases A-B-C, the
top-k copied to host memory, -1 past the valid entries). No query lengths
are given: the mmap path applies no coverage filter. Ids are the shard's
own rows. Batches go back to back.

Queries: a share are noisy copies of drawn DB rows at drawn cosines, the
rest random unit vectors with no close neighbour; a pool of batches is
made once from the seed and cycled. An exact flat scan scores every row
and gathers the same number of blocks whatever the queries, so the mix
sets the answers the check reads, not the work.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.compare import id_gap, rank_gap

BLOCK = 128
GEN_CHUNK = 1 << 22          # rows a generation step (2 GiB of float32)


def shard_rows(cfg: dict) -> int:
    """The DB rows of card `shard_index` when `db_rows` rows are laid out
    as the engine shards them: an equal run of whole blocks a card."""
    n, ndev, me = cfg["db_rows"], cfg["mesh_devices"], cfg["shard_index"]
    per_card = -(-n // (ndev * BLOCK)) * BLOCK
    return min(max(n - me * per_card, 0), per_card)


@torch.no_grad()
def make_shard(rows: int, valid: int, gen, device, dim: int = 128):
    """int8 rows [rows, dim] and per-row block-uniform scales [rows] float32:
    unit Gaussian rows, quantised per 128-row block to [-127, 127] (scale =
    block max / 127, 1.0 for a block of padding); rows >= valid are zero."""
    q = torch.zeros((rows, dim), dtype=torch.int8, device=device)
    scales = torch.ones(rows, dtype=torch.float32, device=device)
    for c0 in range(0, rows, GEN_CHUNK):
        c1 = min(c0 + GEN_CHUNK, rows)
        x = torch.randn((c1 - c0, dim), generator=gen, device=device)
        x /= torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-12)
        if valid < c1:
            x[max(valid - c0, 0):] = 0.0
        a = x.abs().view(-1, BLOCK * dim).amax(dim=1)
        s = torch.where(a > 0, a / 127.0, torch.ones_like(a))
        q[c0:c1] = torch.clamp(torch.round(x.view(-1, BLOCK, dim) / s[:, None, None]),
                               -127, 127).to(torch.int8).view(-1, dim)
        scales[c0:c1] = s.repeat_interleave(BLOCK)
        del x
    return q, scales


@torch.no_grad()
def make_queries(rows8, scales, valid: int, n: int, near_share: float, cos: list,
                 gen, device, dim: int = 128) -> np.ndarray:
    """[n, dim] float32 unit queries on the host: the first near_share of
    them noisy copies of random DB rows (dequantised) at cosines uniform in
    `cos`, the rest random directions."""
    x = torch.randn((n, dim), generator=gen, device=device)
    x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
    near = int(round(n * near_share))
    idx = torch.randint(0, valid, (near,), generator=gen, device=device)
    r = rows8[idx].to(torch.float32) * scales[idx, None]
    r /= torch.linalg.vector_norm(r, dim=1, keepdim=True).clamp_min(1e-12)
    z = x[:near] - (x[:near] * r).sum(1, keepdim=True) * r
    z /= torch.linalg.vector_norm(z, dim=1, keepdim=True).clamp_min(1e-12)
    c = cos[0] + (cos[1] - cos[0]) * torch.rand((near, 1), generator=gen, device=device)
    x[:near] = c * r + torch.sqrt(1.0 - c * c) * z
    perm = torch.randperm(n, generator=gen, device=device)
    return x[perm].cpu().numpy()


def int8_db(rows8: np.ndarray, scales: np.ndarray):
    """The port's FlatDB of the mmap layout over an int8 sidecar held in
    host memory: rows, block scales, and lengths the mmap path never reads."""
    from merizo_search_tpu_torch.db.codecs import FlatDB
    n, dim = rows8.shape
    return FlatDB("mmap", prefix=None, _emb=None, _emb8=rows8, _scales=scales,
                  _lengths=np.broadcast_to(np.int32(0), (n,)),
                  size=n, dim=dim, normalised=True)


class Driver:
    """The system under test for one run: the engine over the shard's rows
    and the query pool; the inputs kept in host memory for the check."""

    CONTROLS = ("int4",)

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from merizo_search_tpu_torch.search.engine import SearchEngine
        self.device = device
        self.cfg, self.traffic = cfg, traffic
        self.valid = shard_rows(cfg)
        self.rows = -(-self.valid // BLOCK) * BLOCK      # the engine's padded shard
        self.k = int(traffic["k"])
        self.queries_per_call = int(traffic["batch"])
        gen = torch.Generator(device=device).manual_seed(seed)
        rows8, scales = make_shard(self.rows, self.valid, gen, device, cfg["dim"])
        pool = make_queries(rows8, scales, self.valid,
                            traffic["pool_batches"] * self.queries_per_call,
                            traffic["near_share"], traffic["cos"], gen, device, cfg["dim"])
        self.pool = pool.reshape(traffic["pool_batches"], self.queries_per_call, cfg["dim"])
        self.host_rows = rows8[:self.valid].cpu().numpy()
        self.host_scales = scales[:self.valid].cpu().numpy()
        del rows8, scales
        if device.type == "cuda":
            torch.cuda.empty_cache()
        self.engine = SearchEngine(int8_db(self.host_rows, self.host_scales), dtype="int8",
                                   device=device)
        if self.engine.mode != "device":
            raise RuntimeError(f"the shard does not fit the engine's device mode "
                               f"({self.engine.mode})")
        self.call(0, None)                   # residency, and the one batch width

    def batch(self, i: int) -> np.ndarray:
        return self.pool[i % len(self.pool)]

    def call(self, i: int, span):
        """One batch through the engine's search."""
        return self.engine.search(self.batch(i), self.k)

    # -- the check ------------------------------------------------------------

    def sample(self, kept: list, seed: int) -> list:
        """(call, query rows) of the check: `per_call` queries of each kept
        call, drawn from the seed."""
        rng = np.random.default_rng([seed, 11])
        m = int(self.traffic["check"]["per_call"])
        return [(i, ans, np.sort(rng.choice(self.queries_per_call, m, replace=False)))
                for i, ans in kept]

    def _operands(self, picks, levels: int = 127):
        from portbench.reference import topk as ref
        q = np.concatenate([self.batch(i)[sel] for i, _, sel in picks])
        return ref.quantize_rows(ref.normalize_rows(q), levels)

    def _inputs(self):
        """The shard's rows and scales on the card, for the reference."""
        if not hasattr(self, "_ref_inputs"):
            self._ref_inputs = (torch.from_numpy(self.host_rows).to(self.device),
                                torch.from_numpy(self.host_scales).to(self.device))
        return self._ref_inputs

    def answers(self, picks) -> tuple[np.ndarray, np.ndarray]:
        """The program's answers to the sampled queries: (scores, ids)."""
        return (np.concatenate([ans[0][sel] for _, ans, sel in picks]),
                np.concatenate([ans[1][sel] for _, ans, sel in picks]))

    def reference(self, picks) -> dict:
        """The plain exact top-k of the sampled queries over the shard."""
        from portbench.reference import topk as ref
        q8, qs = self._operands(picks)
        vals, ids = ref.int8_topk(q8, qs, *self._inputs(), self.valid, self.k)
        return {"q8": q8, "qs": qs, "vals": vals, "ids": ids}

    def control(self, picks, name: str) -> tuple[np.ndarray, np.ndarray]:
        """The lower-precision control in the program's place: the plain
        top-k with queries and rows at int4 (7 levels)."""
        from portbench.reference import topk as ref
        q4, qs4 = self._operands(picks, levels=7)
        vals, ids = ref.int8_topk(q4, qs4, *self._inputs(), self.valid, self.k, levels=7)
        return vals.astype(np.float32), ids

    def compare(self, refr: dict, answers) -> dict:
        """The numbers compared: `score_gap`, the widest gap between the
        program's k scores and the reference's, rank by rank; `id_gap`, the
        widest gap between a returned score and the reference's exact score
        of the id returned with it (a duplicate id reads inf)."""
        from portbench.reference import topk as ref
        vals, ids = answers
        exact = ref.int8_scores_of(refr["q8"], refr["qs"], *self._inputs(), self.valid, ids)
        return {"score_gap": rank_gap(vals, refr["vals"]),
                "id_gap": id_gap(vals, ids, exact)}

    def release(self) -> None:
        """Free the engine and its resident shard before the reference runs."""
        self.engine = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def least_call_s(self) -> float:
        """The least time of one batch's work: the shard read once, its
        int8 operations at the int8 peak."""
        from portbench.peaks import bound_s
        q, dim = self.queries_per_call, self.cfg["dim"]
        return bound_s(self.valid * dim, 2.0 * self.valid * dim * q, "int8")

    def phase_a_work(self) -> tuple[float, float, str]:
        """(bytes, operations, dtype) of phase A on this shard and batch:
        the int8 rows and a scale a block read once, the block maxima
        written once, 2 N 128 Q int8 operations."""
        q, dim = self.queries_per_call, self.cfg["dim"]
        nb = self.rows // BLOCK
        nbytes = self.valid * dim + nb * 4 + q * nb * 4 + q * dim
        return nbytes, 2.0 * self.valid * dim * q, "int8"
