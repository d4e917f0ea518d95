"""The plain reference of the Convolutional Tsetlin Machine (``kind:
"conv"``), which judges the conv cells at their full size on the card.

Plain PyTorch, written from Granmo et al., arXiv:1905.09688 (a ``patch``
× ``patch`` window slid over ``img_h`` × ``img_w`` images; each patch's
pixel bits and a thermometer code of its row and column; a clause fires
on an image when it fires on some patch; Type I and II feedback against
one patch on which the clause fires, picked at random) and from the
random-number contract that the program states: the words of a step are
drawn from the LFSR cluster in the order (negated class [B], patch pick
[B, P, R], selection [2, B, R], TA words [2, B, R, L]) over the engine's
padded geometry; the patch a (row, clause) learns from is the one with
the largest ``fired * 1000 + word % 997``, the first of equals.  The
class sums, the Alg-3 selection, the Alg-4 weight nudges and the Alg-6
group accounting are the paper's (arXiv:2504.19797), as the flat
reference ``portbench/tm_reference.py`` has them.  It imports nothing of
the program and nothing of JAX.

Departures from a one-step-at-a-time description, none of which changes
a word or a state:

* :meth:`Cluster.draw` computes many LFSR cycles at once.  The Galois
  step is linear over GF(2), so a lane's state c cycles on is the XOR of
  the states that each of its bytes alone reaches in c cycles; those are
  tabulated once per width (:func:`_reach`, [BLOCK, bytes, 256]) and
  gathered by the lanes' bytes, ``BLOCK`` cycles at a time.  A seed
  refresh splits a draw where it falls: the cycle that refreshes emits
  the reseeded lanes, and the cycles after it start from them, as one
  cycle at a time would.  The words, ``lanes``, ``master`` and
  ``cycles`` equal ``tm_reference.Cluster.draw``'s.
* A step's patch literals come from one ``unfold`` of the images and a
  thermometer code computed once per image size, not from a loop over
  patch positions.
* Matrix products run in float64, which is exact for these 0/1 and
  small-integer operands; TF32 is switched off all the same before any
  product.  At the MNIST cell's size (B=32, P=361, 2000 clauses, 272
  literals, L=384, R=2048) the largest tensors are the TA draw's 403 MB
  of int64 words, so a step runs whole on the card; only the draw is
  computed in blocks of cycles.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import tm_reference as flat
from portbench.tm_reference import held_ta, model_at  # noqa: F401

KINDS = ("conv",)
BLOCK = 1024        # LFSR cycles a draw computes at once
_REACH: dict = {}   # (bits, device) -> int64 [BLOCK, bytes, 256]


def patches(model: dict) -> int:
    """Patch positions of an image: (img_h - patch + 1)(img_w - patch + 1)."""
    k = model["patch"]
    return (model["img_h"] - k + 1) * (model["img_w"] - k + 1)


def bool_features(model: dict) -> int:
    """A patch's pixel bits and its row and column thermometer bits."""
    k = model["patch"]
    return k * k + (model["img_h"] - k) + (model["img_w"] - k)


def rows_of(model: dict) -> int:
    return model["clauses"]


def has_weights(model: dict) -> bool:
    """The conv machine keeps the CoTM's class weights."""
    return True


def motif_literals(model: dict, task: dict, features):
    """The patch literals [rows, n] of image pixels ``features`` [rows, n]
    (row-major indices): each row's pixels relative to the window at its
    topmost row and leftmost column that lies in the image, a pixel past
    the window wrapped into it (two pixels may share a literal)."""
    k, w = model["patch"], model["img_w"]
    py, px = features // w, features % w
    top = py.min(axis=1, keepdims=True).clip(max=model["img_h"] - k)
    left = px.min(axis=1, keepdims=True).clip(max=w - k)
    return ((py - top) % k) * k + (px - left) % k


def weight_matrix(model: dict, weights, device) -> torch.Tensor:
    """Class weights [classes, clauses] int64, held in the model's weight
    bits (the CoTM's, which the conv machine shares)."""
    clip = (1 << (model["weight_bits"] - 1)) - 1
    return torch.as_tensor(weights, device=device).to(torch.int64).clamp(
        -clip, clip)


def _exact() -> None:
    """No float product of this module may run in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# the LFSR cluster, many cycles at once
# ---------------------------------------------------------------------------

def _reach(bits: int, device) -> torch.Tensor:
    """int64 [BLOCK, bytes, 256]: entry [c, k, v] is the state that the
    lane state ``v << 8k`` reaches c + 1 Galois steps on."""
    key = (bits, str(device))
    if key not in _REACH:
        cols = np.empty((BLOCK, bits), np.int64)   # the unit states, stepped
        s = np.left_shift(1, np.arange(bits, dtype=np.int64))
        for c in range(BLOCK):
            s = (s >> 1) ^ ((s & 1) * flat.TAPS[bits])
            cols[c] = s
        v = np.arange(256, dtype=np.int64)
        tab = np.zeros((BLOCK, -(-bits // 8), 256), np.int64)
        for j in range(bits):
            tab[:, j // 8] ^= ((v >> (j % 8)) & 1)[None, :] * cols[:, j, None]
        _REACH[key] = torch.as_tensor(tab, device=device)
    return _REACH[key]


def advance(lanes: torch.Tensor, cycles: int, bits: int) -> torch.Tensor:
    """The lanes' states after each of ``cycles`` Galois steps, int64
    [cycles, n], without a refresh."""
    out = []
    for a in range(0, cycles, BLOCK):
        tab = _reach(bits, lanes.device)[:min(BLOCK, cycles - a)]
        st = tab[:, 0].index_select(1, lanes & 255)
        for k in range(1, tab.shape[1]):
            st ^= tab[:, k].index_select(1, (lanes >> (8 * k)) & 255)
        out.append(st)
        lanes = st[-1]
    return torch.cat(out)


@dataclasses.dataclass
class Cluster(flat.Cluster):
    """The paper's PRNG cluster (``tm_reference.Cluster``) with a draw
    that computes many cycles at once."""

    @staticmethod
    def create(seed: int, n_lanes: int, bits: int, device) -> "Cluster":
        c = flat.Cluster.create(seed, n_lanes, bits, device)
        return Cluster(c.lanes, c.master, c.cycles)

    def draw(self, size: int, model: dict) -> torch.Tensor:
        """``size`` words: whole cycles of every lane, the rest of the
        last cycle dropped.  Advances the cluster."""
        bits, rb = model["lfsr_bits"], model["rand_bits"]
        n, period = self.lanes.shape[0], (1 << bits) - 1
        left = -(-size // n)
        out = []
        while left:
            plain = left
            if model["seed_refresh"]:
                plain = max(0, min(left, period - self.cycles - 1))
            if plain:
                st = advance(self.lanes, plain, bits)
                out.append(st)
                self.lanes, self.cycles = st[-1], self.cycles + plain
                left -= plain
            if left:                        # this cycle refreshes
                self.master = int(flat.xorshift32(torch.tensor(self.master)))
                self.lanes = flat.seed_lanes(
                    torch.tensor(self.master, device=self.lanes.device),
                    n, bits)
                self.cycles = 0
                out.append(self.lanes[None])
                left -= 1
        return flat.emit(torch.cat(out), bits, rb).reshape(-1)[:size]


# ---------------------------------------------------------------------------
# inference and the training step
# ---------------------------------------------------------------------------

def patch_literals(model: dict, x, slots: int = 0) -> torch.Tensor:
    """Images [B, h, w] {0,1} -> literals [B, P, 2f] (x, then not x), the
    patches row-major, each the window's pixels row-major and then the
    thermometer code of its row (``i > t``, t < h - patch) and column;
    ``slots`` > P pads patch slots whose literals are all 0."""
    x = torch.as_tensor(x).to(torch.int64)
    k, h, w = model["patch"], model["img_h"], model["img_w"]
    B, dev = x.shape[0], x.device
    pix = x.unfold(1, k, 1).unfold(2, k, 1).reshape(B, -1, k * k)
    i = torch.arange(h - k + 1, device=dev)
    j = torch.arange(w - k + 1, device=dev)
    row = (i[:, None] > torch.arange(h - k, device=dev)).to(torch.int64)
    col = (j[:, None] > torch.arange(w - k, device=dev)).to(torch.int64)
    code = torch.cat([row[:, None, :].expand(-1, len(j), -1),
                      col[None, :, :].expand(len(i), -1, -1)], dim=-1)
    feats = torch.cat([pix, code.reshape(1, -1, code.shape[-1]).expand(
        B, -1, -1)], dim=-1)                                   # [B, P, f]
    lits = torch.cat([feats, 1 - feats], dim=-1)
    if slots > lits.shape[1]:
        lits = torch.nn.functional.pad(lits, (0, 0, 0,
                                              slots - lits.shape[1]))
    return lits


def patch_clauses(model: dict, ta: torch.Tensor, lits: torch.Tensor,
                  eval_mode: bool) -> torch.Tensor:
    """Clause c fires on patch p of row b iff every included literal is 1
    there; an all-0 padded slot fires nowhere; at inference an empty
    clause does not fire.  int64 [B, P, rows]."""
    _exact()
    inc = (ta >= (1 << (model["ta_bits"] - 1))).to(torch.float64)
    viol = (1 - lits).to(torch.float64) @ inc.T
    real = lits.sum(dim=-1, keepdim=True) > 0
    fired = (viol == 0) & real
    if eval_mode:
        fired &= (inc.sum(dim=1) > 0)
    return fired.to(torch.int64)


def predict(model: dict, ta, weights, x, device, block: int = 1024):
    """Answers (argmax class, the first of equal sums) of images ``x``."""
    _exact()
    ta = held_ta(model, ta, device)
    w = weight_matrix(model, weights, device)
    out = []
    for a in range(0, len(x), block):
        lits = patch_literals(model, torch.as_tensor(x[a:a + block],
                                                     device=device))
        cl = patch_clauses(model, ta, lits, True).amax(dim=1)
        out.append(torch.argmax(flat.class_sums(w, cl), dim=1))
    return torch.cat(out)


def train_step(model: dict, engine: dict, ta, weights, prng: Cluster,
               x, y):
    """One training step on images ``x`` [B, h, w] with labels ``y`` [B].
    Returns (ta int64 [rows, 2f], weights int64 [classes, clauses], stats:
    0-d int64 tensors); advances ``prng``."""
    _exact()
    dev = ta.device
    B = x.shape[0]
    rows, h, f = rows_of(model), model["classes"], bool_features(model)
    R, L = engine["R"], engine["L"]
    P = engine.get("P", patches(model))
    c_rand = prng.draw(B, model)
    pick = prng.draw(B * P * R, model).view(B, P, R)[:, :, :rows]
    sel_rand = prng.draw(2 * B * R, model).view(2, B, R)[:, :, :rows]
    col = torch.arange(2 * f, device=dev)
    col = torch.where(col < f, col, col - f + L // 2)
    ta_rand = prng.draw(2 * B * R * L, model).view(2, B, R, L)[
        :, :, :rows][..., col]                              # [2, B, rows, 2f]

    y = torch.as_tensor(y, device=dev).to(torch.int64)
    lits = patch_literals(model, torch.as_tensor(x, device=dev), P)
    w = weight_matrix(model, weights, dev)
    cl_p = patch_clauses(model, ta, lits, eval_mode=False)     # [B, P, rows]
    cl = cl_p.amax(dim=1)
    sums = flat.class_sums(w, cl)
    rn = c_rand % max(h - 1, 1)
    neg = torch.where(rn < y, rn, rn + 1)
    sel_lab, w_lab = flat._select(model, sums, y, True, sel_rand[0], w)
    sel_neg, w_neg = flat._select(model, sums, neg, False, sel_rand[1], w)

    # the patch each (row, clause) learns from, and its literals
    at = torch.argmax(cl_p * 1000 + pick % 997, dim=1)           # [B, rows]
    lit = torch.gather(lits, 1, at[..., None].expand(-1, -1, 2 * f)) > 0
    fired = (cl > 0)[..., None]
    include = ta >= (1 << (model["ta_bits"] - 1))
    fired_lit = fired & lit
    type2 = (fired & ~lit & ~include).to(torch.int64)
    p_ta = int(round((1 << model["rand_bits"]) / model["s"]))
    delta = torch.zeros_like(ta)
    for t1, t2, words in ((sel_lab * (w_lab >= 0), sel_lab * (w_lab < 0),
                           ta_rand[0]),
                          (sel_neg * (w_neg < 0), sel_neg * (w_neg >= 0),
                           ta_rand[1])):
        low = words < p_ta
        up = fired_lit if model["boost_true_positive"] else fired_lit & ~low
        d1 = up.to(torch.int64) - (~fired_lit & low).to(torch.int64)
        delta += (t1[..., None] * d1 + t2[..., None] * type2).sum(dim=0)
    new_ta = (ta + delta).clamp(0, (1 << model["ta_bits"]) - 1)

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
