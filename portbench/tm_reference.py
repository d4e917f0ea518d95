"""The plain reference of the Tsetlin Machines the benchmark runs.

Plain PyTorch, written from the paper (arXiv:2504.19797: Alg 3 clause
selection, Alg 4 weight update, Alg 5 TA update, Alg 6 group accounting,
the LFSR cluster of Fig 8) and from the random-number contract that the
program states in its configuration (``engine`` in a configuration file):
which words of the cluster each draw of a step takes, and how each TA's
in-kernel stream is keyed.  It imports nothing of the program and takes
nothing that the program made: TA states and weights are the
benchmark's own arrays, in the model's layout ([rows, 2f], literals x
then not-x); the engine's padded layout appears only as the stream keys
and the Alg-6 groups are defined on it.

uint32 arithmetic runs in int64 tensors masked to 32 bits.  Matrix
products run in float64, which is exact for these 0/1 and small-integer
operands, so TF32 cannot creep in.

``drop`` (on :func:`model_at`) gives the control: the same model with its
TA registers and weights one bit narrower, the nearest precision below
the one the configuration states.

The flat kinds' reference: a configuration that names no reference of
its own is judged by this one, which judges the kinds in :data:`KINDS`.
"""
from __future__ import annotations

import dataclasses

import torch

M32 = 0xFFFFFFFF
# Maximal-length Galois LFSR tap masks (polynomial without x^0), by width.
TAPS = {4: 0b1100, 8: 0b10111000, 12: 0b111000001000,
        16: 0b1101000000001000, 20: 0b10010000000000000000,
        24: 0b111000010000000000000000,
        32: 0b10000000001000000000000000000110}
# the model kinds this reference judges
KINDS = ("coalesced", "vanilla")


def bool_features(model: dict) -> int:
    """Boolean features a clause sees: the flat kinds' own features."""
    return model["features"]


def has_weights(model: dict) -> bool:
    """Whether a program carries class weights of its own: the CoTM's;
    the Vanilla TM's class blocks are a fixed ±1 by clause parity."""
    return model["kind"] == "coalesced"


def motif_literals(model: dict, task: dict, features):
    """The x-literal columns [rows, n] of a clause that includes the task
    features ``features`` [rows, n]: a flat clause sees them as they are."""
    return features


def model_at(model: dict, drop: int = 0) -> dict:
    """The model with ``drop`` fewer TA and weight bits (the control)."""
    return dict(model, ta_bits=model["ta_bits"] - drop,
                weight_bits=model["weight_bits"] - drop)


def rows_of(model: dict) -> int:
    """Clause rows a model holds (Vanilla: clauses per class × classes)."""
    if model["kind"] == "vanilla":
        return model["clauses"] * model["classes"]
    return model["clauses"]


def weight_matrix(model: dict, weights, device) -> torch.Tensor:
    """Class weights [classes, rows] int64: CoTM's own (held in the
    model's weight bits), Vanilla's block of ±1 by clause parity."""
    h, c = model["classes"], model["clauses"]
    if model["kind"] == "coalesced":
        clip = (1 << (model["weight_bits"] - 1)) - 1
        w = torch.as_tensor(weights, device=device).to(torch.int64)
        return w.clamp(-clip, clip)
    w = torch.zeros((h, h * c), dtype=torch.int64, device=device)
    pol = 1 - 2 * (torch.arange(c, device=device) % 2)
    for k in range(h):
        w[k, k * c:(k + 1) * c] = pol
    return w


def held_ta(model: dict, ta, device) -> torch.Tensor:
    """TA states as the model's registers hold them, int64 [rows, 2f]."""
    top = (1 << model["ta_bits"]) - 1
    return torch.as_tensor(ta, device=device).to(torch.int64).clamp(0, top)


# ---------------------------------------------------------------------------
# the LFSR cluster (paper Fig 8): master and lanes, refreshed every 2^L - 1
# ---------------------------------------------------------------------------

def splitmix32(x: torch.Tensor) -> torch.Tensor:
    x = (x + 0x9E3779B9) & M32
    z = ((x ^ (x >> 16)) * 0x21F0AAAD) & M32
    z = ((z ^ (z >> 15)) * 0x735A2D97) & M32
    return z ^ (z >> 15)


def xorshift32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ ((x << 13) & M32)
    x = x ^ (x >> 17)
    return x ^ ((x << 5) & M32)


def lfsr_step(lanes: torch.Tensor, bits: int) -> torch.Tensor:
    """One Galois step: shift right, xor the taps in when the bit shifted
    out was 1."""
    return (lanes >> 1) ^ ((lanes & 1) * TAPS[bits])


def seed_lanes(master: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    idx = torch.arange(n, dtype=torch.int64, device=master.device)
    s = splitmix32(master ^ idx) & ((1 << bits) - 1)
    return torch.where(s == 0, torch.ones_like(s), s)


def emit(lanes: torch.Tensor, bits: int, rand_bits: int) -> torch.Tensor:
    if bits < rand_bits:
        lanes = (lanes << (rand_bits - bits)) & M32
    elif bits > rand_bits:
        lanes = lanes >> (bits - rand_bits)
    return lanes & ((1 << rand_bits) - 1)


@dataclasses.dataclass
class Cluster:
    """The paper's PRNG cluster: ``lanes`` int64 [n], ``master`` and
    ``cycles`` Python ints (uint32)."""

    lanes: torch.Tensor
    master: int
    cycles: int

    @staticmethod
    def create(seed: int, n_lanes: int, bits: int, device) -> "Cluster":
        master = (seed & M32) or 0xDEADBEEF
        m = torch.tensor(master, dtype=torch.int64, device=device)
        return Cluster(seed_lanes(m, n_lanes, bits), master, 0)

    def draw(self, size: int, model: dict) -> torch.Tensor:
        """``size`` words: whole cycles of every lane, the rest of the
        last cycle dropped.  Advances the cluster."""
        bits, rb = model["lfsr_bits"], model["rand_bits"]
        n = self.lanes.shape[0]
        out = []
        for _ in range(-(-size // n)):
            self.lanes = lfsr_step(self.lanes, bits)
            self.cycles += 1
            if model["seed_refresh"] and self.cycles >= (1 << bits) - 1:
                self.master = int(xorshift32(torch.tensor(self.master)))
                self.lanes = seed_lanes(
                    torch.tensor(self.master, device=self.lanes.device),
                    n, bits)
                self.cycles = 0
            out.append(emit(self.lanes, bits, rb))
        return torch.cat(out)[:size]


# ---------------------------------------------------------------------------
# inference and the training step
# ---------------------------------------------------------------------------

def literals(x) -> torch.Tensor:
    """Boolean features [B, f] -> literals [B, 2f] (x, then not x)."""
    x = torch.as_tensor(x).to(torch.int64)
    return torch.cat([x, 1 - x], dim=-1)


def clause_outputs(model: dict, ta: torch.Tensor, lits: torch.Tensor,
                   eval_mode: bool) -> torch.Tensor:
    """Clause c fires on row b iff every included literal is 1; at
    inference an empty clause does not fire.  int64 [B, rows]."""
    inc = (ta >= (1 << (model["ta_bits"] - 1))).to(torch.float64)
    viol = (1 - lits).to(torch.float64) @ inc.T
    fired = viol == 0
    if eval_mode:
        fired &= (inc.sum(dim=1) > 0)[None, :]
    return fired.to(torch.int64)


def class_sums(w: torch.Tensor, cl: torch.Tensor) -> torch.Tensor:
    return torch.round(cl.to(torch.float64) @ w.to(torch.float64).T).to(
        torch.int64)


def predict(model: dict, ta, weights, x, device, block: int = 4096):
    """Answers (argmax class, the first of equal sums) of rows ``x``,
    int64 [n], computed ``block`` rows at a time."""
    ta = held_ta(model, ta, device)
    w = weight_matrix(model, weights, device)
    out = []
    for a in range(0, len(x), block):
        lit = literals(torch.as_tensor(x[a:a + block], device=device))
        sums = class_sums(w, clause_outputs(model, ta, lit, True))
        out.append(torch.argmax(sums, dim=1))
    return torch.cat(out)


def stream_keys(model: dict, engine: dict, device) -> torch.Tensor:
    """Key of each TA's stream, int64 [rows, 2f]: its row times the
    engine's literal stride (the padded literal count rounded up to
    ``stream_tile``) plus its column in the engine's layout (x at 0,
    not-x at half the padded literal count)."""
    f, L = model["features"], engine["L"]
    stride = -(-L // engine["stream_tile"]) * engine["stream_tile"]
    col = torch.arange(2 * f, dtype=torch.int64, device=device)
    col = torch.where(col < f, col, col - f + L // 2)
    r = torch.arange(rows_of(model), dtype=torch.int64, device=device)
    return (r[:, None] * stride + col[None, :]) & M32


def ta_update(model: dict, engine: dict, ta, lits2, cl2, t1, t2, seed):
    """Alg 5 over the 2B feedback rows (target round, then negated round):
    each TA's stream is an LFSR lane seeded from (seed, key), one step per
    row whether or not the row gives feedback.  The deltas of every row
    are summed, then added and clipped once.  ``seed`` is a 0-d tensor.

    Type I feedback (``t1``) includes a fired clause's true literals
    (always with ``boost_true_positive``, else with probability 1 - 1/s)
    and excludes every other literal with probability 1/s; Type II
    (``t2``) includes a fired clause's false, excluded literals.  The
    terms without a random word are integer counts, summed over the rows
    as float64 products (exact); the 1/s draws walk the rows."""
    rb, bits = model["rand_bits"], model["lfsr_bits"]
    top = (1 << model["ta_bits"]) - 1
    p_ta = int(round((1 << rb) / model["s"]))
    # emit(lane) < p_ta, on the lane itself (lanes hold ``bits`` bits):
    # lane >> k < p iff lane < p << k; lane << k < p iff lane < ceil(p/2^k)
    low_below = (p_ta << (bits - rb) if bits >= rb
                 else -(-p_ta >> (rb - bits)))
    key = stream_keys(model, engine, ta.device)
    lane_t = torch.int32 if bits < 32 else torch.int64

    def seeded(s):
        lanes = splitmix32(s ^ key) & ((1 << bits) - 1)
        return torch.where(lanes == 0, torch.ones_like(lanes), lanes).to(
            lane_t)
    lanes = seeded(seed)
    master, cycles = seed, 0
    include = ta >= (1 << (model["ta_bits"] - 1))
    lit = lits2 > 0                                              # [2B, 2f]
    cl = cl2 > 0                                                 # [2B, rows]
    on1, on2 = (t1 > 0) & cl, (t2 > 0) & cl
    f64 = torch.float64
    # Type II: fired, literal false, TA excluded
    delta = torch.round(on2.to(f64).T @ (~lit).to(f64)).to(torch.int64)
    delta *= ~include
    if model["boost_true_positive"]:
        delta += torch.round(on1.to(f64).T @ lit.to(f64)).to(torch.int64)
    # each row's draws [2B, rows, 2f]: one Galois step a row, compared
    low = torch.empty((lits2.shape[0], *ta.shape), dtype=torch.bool,
                      device=ta.device)
    for b in range(lits2.shape[0]):
        lanes = lfsr_step(lanes, bits)
        cycles += 1
        if model["seed_refresh"] and cycles >= (1 << bits) - 1:
            master = xorshift32(master)
            lanes = seeded(master)
            cycles = 0
        torch.lt(lanes, low_below, out=low[b])
    fired_lit = on1[:, :, None] & lit[:, None, :]
    down = ((t1 > 0)[:, :, None] & ~fired_lit & low).sum(dim=0)
    if not model["boost_true_positive"]:
        down -= (fired_lit & ~low).sum(dim=0)
    return (ta + delta - down).clamp(0, top)


def _select(model, sums, cls, target: bool, rand, w):
    """Alg 3 for one round: clause c is picked for row b with probability
    (T -/+ clip(sum of b's class)) / 2T, among the rows that class may
    update (a frozen Vanilla model: its own block)."""
    T, rb = model["T"], model["rand_bits"]
    cs = torch.gather(sums, 1, cls[:, None]).clamp(-T, T)
    p_num = T - cs if target else T + cs
    sel = rand * (2 * T) < (p_num << rb)
    w_r = w[cls]                                                # [B, rows]
    if model["kind"] == "vanilla":
        sel &= w_r != 0
    return sel.to(torch.int64), w_r


def train_step(model: dict, engine: dict, ta, weights, prng: Cluster,
               x, y):
    """One training step on the rows ``x`` [B, f] with labels ``y`` [B].
    Returns (ta int64 [rows, 2f], weights int64 [classes, clauses] or
    None, stats: 0-d int64 tensors, so that a step waits for nothing);
    advances ``prng``."""
    dev = ta.device
    B = x.shape[0]
    rows, h, R = rows_of(model), model["classes"], engine["R"]
    rb = model["rand_bits"]
    c_rand = prng.draw(B, model)
    sel_rand = prng.draw(2 * B * R, model).view(2, B, R)[:, :, :rows]
    sb = prng.draw(2, model)
    seed = ((sb[0] << rb) | sb[1]) & M32

    y = torch.as_tensor(y, device=dev).to(torch.int64)
    lits = literals(torch.as_tensor(x, device=dev))
    w = weight_matrix(model, weights, dev)
    cl = clause_outputs(model, ta, lits, eval_mode=False)
    sums = class_sums(w, cl)
    rn = c_rand % max(h - 1, 1)
    neg = torch.where(rn < y, rn, rn + 1)
    sel_lab, w_lab = _select(model, sums, y, True, sel_rand[0], w)
    sel_neg, w_neg = _select(model, sums, neg, False, sel_rand[1], w)
    t1 = torch.cat([sel_lab * (w_lab >= 0), sel_neg * (w_neg < 0)])
    t2 = torch.cat([sel_lab * (w_lab < 0), sel_neg * (w_neg >= 0)])
    new_ta = ta_update(model, engine, ta, torch.cat([lits, lits]),
                       torch.cat([cl, cl]), t1, t2, seed)

    new_w = None
    if model["kind"] == "coalesced":
        d_w = torch.zeros_like(w)
        d_w.index_add_(0, y, sel_lab * cl)
        d_w.index_add_(0, neg, -(sel_neg * cl))
        clip = (1 << (model["weight_bits"] - 1)) - 1
        new_w = (w + d_w).clamp(-clip, clip)

    g = engine["group"]
    per_row = torch.zeros(R, dtype=torch.int64, device=dev)
    per_row[:rows] = (sel_lab + sel_neg).sum(dim=0)
    real = torch.zeros(R, dtype=torch.bool, device=dev)
    real[:rows] = True
    groups = real.view(-1, g).any(dim=1)
    stats = {"selected": per_row.sum(),
             "active_groups": ((per_row > 0).view(-1, g).any(dim=1)
                               & groups).sum(),
             "total_groups": groups.sum(),
             "correct": (torch.argmax(sums, dim=1) == y).sum()}
    return new_ta, new_w, stats
