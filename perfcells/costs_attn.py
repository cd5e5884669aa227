"""Operations and bytes of the attention encoder (``config4-attn3``), from
shapes: what its roofline and its training step's model FLOPs are priced at.

The work is the model's, whatever computes it: ``perfcells/reference/attn.py``
names it.  A block at B windows of N agents and T steps (P = B·N·T tokens,
G = B·T frame graphs) runs these matrix products forward, 2 m k n each:
q, k, v and the output of the temporal attention (4 x 2 P H^2), its scores
and aggregate (2 x 2 P T H), the GAT's value and output (2 x 2 P H^2) and
aggregate (2 G N^2 H), and the MLP (2 x 2 P H 4H).  The rest (layer norms,
softmax, the GAT's scores and chain, biases, ReLU, residuals) runs outside
the tensor cores.  Bytes: each input read once (the block's x, the frames'
boolean adjacency and mask, its weights) and each output written once.  A
backward computes every product's two operand gradients (twice the forward's
products), reads x, the output's gradient and the weights and writes x's
and the weights' gradients.  Around the blocks: the embedding (whose input
is data, so its backward computes the weight's gradient alone), the
projection, the positions, the adjacency and the readout's layer norm.

``costs.least_time_s`` prices each part at the card's peaks; a stretch of
work is priced at the sum of its parts' least times.
"""

from __future__ import annotations

from perfcells import costs


def _sizes(cfg: dict, batch: int, n: int, t: int) -> tuple:
    return (cfg["hidden_dim"], cfg["embed_dim"], cfg["num_heads"], batch * n * t, batch * t)


def block_forward(cfg: dict, batch: int, n: int, t: int) -> tuple:
    """One block application: -> (flops, bytes, product flops)."""
    H, _, heads, P, G = _sizes(cfg, batch, n, t)
    products = P * (28 * H * H + 4 * t * H) + 2 * G * n * n * H
    rest = 43 * P * H + 6 * P * t * heads + 7 * G * heads * n * n
    weights = 14 * H * H + 15 * H
    nbytes = 4 * (2 * P * H + weights) + G * n * n + G * n
    return products + rest, nbytes, products


def block_backward(cfg: dict, batch: int, n: int, t: int) -> tuple:
    """The backward of one block: -> (flops, bytes, product flops)."""
    flops, _, products = block_forward(cfg, batch, n, t)
    H, _, _, P, G = _sizes(cfg, batch, n, t)
    weights = 14 * H * H + 15 * H
    nbytes = 4 * (3 * P * H + 2 * weights) + G * n * n + G * n
    return 2 * flops, nbytes, 2 * products


def outside_forward(cfg: dict, batch: int, n: int, t: int) -> tuple:
    """The encoder around its blocks, forward: embedding, projection,
    positions, the frames' adjacency and the readout."""
    H, E, _, P, G = _sizes(cfg, batch, n, t)
    products = P * (2 * 2 * E + 2 * E * H)
    rest = 2 * P * E + 2 * P * H + 8 * G * n * n + 9 * batch * n * H
    weights = 3 * E + E * H + H + 2 * H
    nbytes = 4 * (2 * P * 2 + batch * n * H + weights) + batch * n + G * n * n
    return products + rest, nbytes, products


def outside_backward(cfg: dict, batch: int, n: int, t: int) -> tuple:
    """Their backward: the embedding's weight gradient alone, the
    projection's two, the readout's layer norm."""
    H, E, _, P, _ = _sizes(cfg, batch, n, t)
    products = P * (2 * 2 * E + 2 * 2 * E * H)
    rest = 2 * (2 * P * E + 2 * P * H + 9 * batch * n * H)
    weights = 3 * E + E * H + H + 2 * H
    nbytes = 4 * (P * 2 + 2 * P * E + batch * n * H + 2 * weights)
    return products + rest, nbytes, products


def encoder_forward_products(cfg: dict, batch: int, n: int, t: int) -> float:
    """Product FLOPs of one forward encode."""
    return (outside_forward(cfg, batch, n, t)[2]
            + cfg["attn_layers"] * block_forward(cfg, batch, n, t)[2])


def encoder_least_time_s(cfg: dict, batch: int, n: int, t: int, applications: int,
                         backward: bool) -> float:
    """The least time of an encode of ``applications`` block applications
    (forward and any recomputation) and, where ``backward``, one backward of
    each of the ``attn_layers`` blocks and of the parts around them."""
    parts = [(1, outside_forward), (applications, block_forward)]
    if backward:
        parts += [(1, outside_backward), (cfg["attn_layers"], block_backward)]
    return sum(k * costs.least_time_s(*fn(cfg, batch, n, t)) for k, fn in parts)


def train_step_products(cfg: dict, batch: int, n: int, obs_len: int, pred_len: int) -> float:
    """Model FLOPs of one teacher-forced NLL step at (batch, n): the
    encoder's, bridge's and decoder's products forward and backward, no
    recomputation.  The decoder's step embeds data (its backward computes
    the weight's gradient alone); its last advance feeds no loss, so it has
    no backward."""
    enc = (outside_forward(cfg, batch, n, obs_len)[2] + outside_backward(cfg, batch, n, obs_len)[2]
           + 3 * cfg["attn_layers"] * block_forward(cfg, batch, n, obs_len)[2])
    p = costs._step_products(cfg, n)
    H = cfg["hidden_dim"]
    grads = 2 * (p["gru_x"] + p["gru_h"] + p["gat_v"] + p["gat_agg"] + p["gat_out"])
    step = p["embed"] + p["gru_x"] + p["gru_h"] + p["gat_v"] + p["gat_agg"] + p["gat_out"]
    dec = (pred_len * (p["head"] + step) + 2 * pred_len * p["head"]
           + (pred_len - 1) * (p["embed"] + grads))
    return enc + batch * n * (3 * 2 * H * H + dec)
