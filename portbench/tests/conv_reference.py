"""A plain reference of the Convolutional Tsetlin Machine (``kind:
"conv"``), for the harness's tests: a configuration that names this file
as its ``reference`` is judged by it, which shows that a program kind of
its own needs only new files.

Written from Granmo et al., arXiv:1905.09688 (a ``patch`` × ``patch``
window slid over ``img_h`` × ``img_w`` images; each patch's pixel bits and
a thermometer code of its row and column; a clause fires on an image when
it fires on some patch; Type I and II feedback against one patch on which
the clause fires, picked at random) and from the random-number contract
that the program states: the words of a step are drawn from the LFSR
cluster in the order (negated class [B], patch pick [B, P, R], selection
[2, B, R], TA words [2, B, R, L]) over the engine's padded geometry; the
patch a (row, clause) is the one with the largest ``fired * 1000 + word %
997``, the first of equals.  The cluster, the class sums and the Alg-3
selection are the flat reference's (``portbench/tm_reference.py``).
Memory grows with B × R × L: it is sized for the tests' tiny cells.
"""
from __future__ import annotations

import torch

from portbench import tm_reference as flat
from portbench.tm_reference import Cluster, held_ta, model_at  # noqa: F401

KINDS = ("conv",)


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


def patch_literals(model: dict, x, slots: int = 0) -> torch.Tensor:
    """Images [B, h, w] {0,1} -> literals [B, P, 2f] (x, then not x), the
    patches row-major; ``slots`` > P pads patch slots whose literals are
    all 0."""
    x = torch.as_tensor(x).to(torch.int64)
    k, h, w = model["patch"], model["img_h"], model["img_w"]
    B = x.shape[0]
    rows = []
    for i in range(h - k + 1):
        for j in range(w - k + 1):
            pix = x[:, i:i + k, j:j + k].reshape(B, k * k)
            code = [int(i > t) for t in range(h - k)] + \
                [int(j > t) for t in range(w - k)]
            pos = torch.tensor(code, dtype=torch.int64,
                               device=x.device).expand(B, -1)
            rows.append(torch.cat([pix, pos], dim=1))
    feats = torch.stack(rows, dim=1)                           # [B, P, f]
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
    inc = (ta >= (1 << (model["ta_bits"] - 1))).to(torch.float64)
    viol = (1 - lits).to(torch.float64) @ inc.T
    real = lits.sum(dim=-1, keepdim=True) > 0
    fired = (viol == 0) & real
    if eval_mode:
        fired &= (inc.sum(dim=1) > 0)
    return fired.to(torch.int64)


def predict(model: dict, ta, weights, x, device, block: int = 1024):
    """Answers (argmax class, the first of equal sums) of images ``x``."""
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
