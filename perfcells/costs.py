"""Operations and bytes from shapes, and the card's peaks: the yardstick of
every roofline and MFU the benchmark reports.

A kernel's least time is the largest of three terms: its bytes over the
HBM bandwidth, its matrix products over the dense TF32 tensor-core rate,
and its other operations over the float32 rate outside the tensor cores.
Each input byte is counted read once and each output byte written once.
The counts follow the shapes of a call, never an implementation, so a later
kernel is held to the same work.

Model FLOPs are the forecaster's matrix products (embedding, GRU, GAT value,
aggregate and output products, GMM head, bridge), 2 m k n each, forward and,
for a training step, every product autograd's backward runs.
"""

from __future__ import annotations

# Published peaks of one H100 SXM (dense, no sparsity).
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12


def least_time_s(flops: float, nbytes: float, products: float) -> float:
    """The least time of a call: bytes, products on the tensor cores, or the
    rest on the float32 units, whichever takes longest."""
    return max(nbytes / HBM_BYTES_PER_S, products / TF32_FLOPS,
               (flops - products) / FP32_FLOPS)


def attend_cost(b, n, hd, h):
    """``attend`` over b graphs of n agents, h heads of hd/h: -> (flops,
    bytes, product flops).  Per graph 2 N^2 HD for the aggregate, 7 H N^2
    for the chain, N HD for the division."""
    products = b * 2 * n * n * hd
    flops = products + b * (7 * h * n * n + n * hd)
    nbytes = 4 * (2 * b * n * hd + 2 * b * n * h + b * n * n)
    return flops, nbytes, products


def gat_cost(b, n, d, hd, h, dout):
    """The whole GAT layer (``fused_gat``) over b graphs: value, aggregate
    and output products; scores, chain, division and bias the rest."""
    products = b * (2 * n * d * hd + 2 * n * n * hd + 2 * n * hd * dout)
    flops = products + b * (4 * n * hd + 7 * h * n * n + n * hd + n * dout)
    weights = d * hd + 2 * hd + hd * dout + dout
    nbytes = 4 * (b * n * d + b * n * n + b * n * dout + weights)
    return flops, nbytes, products


def lanes_cost(s, b, n, d, hd, h, dout):
    """``gat_cost`` of s lanes of b graphs, each lane reading its own weights
    (``fused_gat_lanes``)."""
    flops, nbytes, products = gat_cost(s * b, n, d, hd, h, dout)
    weights = d * hd + 2 * hd + hd * dout + dout
    return flops, nbytes + 4 * (s - 1) * weights, products


def decode_cost(b, t, n, hid, e, hd, h, m, n_weights):
    """The whole rollout (``fused_decode``): b graphs, t steps of n agents;
    per agent and step the head, sampling, embedding, GRU, value and score
    products, adjacency, attend chain, output product and residual.  Bytes:
    the initial state, positions and mask, the streams, the weights and the
    trajectory."""
    products = (2 * hid * 6 * m + 2 * (e + hid) * 3 * hid + 2 * hid * hd + 2 * n * hd
                + 2 * hd * hid)
    per = (products + 6 * m + 40 + 2 * 2 * e + 2 * e + 3 * hid + 12 * hid + 4 * hd + 8 * n
           + 7 * h * n + hd + 3 * hid)
    nbytes = 4 * (b * n * hid + 2 * b * n + b * n + b * t * n * m + b * t * n * 2
                  + n_weights + b * t * n * 2)
    return b * t * n * per, nbytes, b * t * n * products


def decoder_weights(hid, e, hd, m):
    """Parameters ``fused_decode`` reads: the decoder's embedding, GRU and
    GAT, and the head."""
    return (2 * e + e + e * 3 * hid + hid * 3 * hid + 3 * hid
            + hid * hd + 2 * hd + hd * hid + hid + hid * 6 * m + 6 * m)


# -- model FLOPs ----------------------------------------------------------------

def _step_products(cfg: dict, n: int) -> dict:
    """Each matrix product of one agent's recurrent step at n agents a graph."""
    E, H, M = cfg["embed_dim"], cfg["hidden_dim"], cfg["num_mixtures"]
    return {"head": 2 * H * 6 * M, "embed": 2 * 2 * E, "gru_x": 2 * E * 3 * H,
            "gru_h": 2 * H * 3 * H, "gat_v": 2 * H * H, "gat_agg": 2 * n * H,
            "gat_out": 2 * H * H}


def forward_products(cfg: dict, agents: int, n: int, k: int, obs_len: int,
                     pred_len: int) -> float:
    """Forward FLOPs of encoding ``agents`` agent slots in graphs of n and
    rolling out k samples of each for ``pred_len`` steps (``rollout_k``)."""
    p = _step_products(cfg, n)
    step = sum(v for key, v in p.items() if key != "head")
    H = cfg["hidden_dim"]
    return agents * (obs_len * step + 2 * H * H + k * pred_len * (step + p["head"]))


def train_step_products(cfg: dict, batch: int, n: int, variety_n: int, obs_len: int,
                        pred_len: int) -> float:
    """FLOPs of one lane's variety-loss training step at (batch, n): the
    forward (``forward_products``) and every product its backward runs.  A
    backward computes each operand's gradient that is needed: none for the
    data's embedding input, none for the zero initial state of the first
    encoder step, and nothing for the last rollout step's state update,
    whose result no loss reads."""
    p = _step_products(cfg, n)
    H = cfg["hidden_dim"]
    A, G = batch * n, variety_n * batch * n
    enc_fwd = obs_len * (p["embed"] + p["gru_x"] + p["gru_h"] + p["gat_v"] + p["gat_agg"]
                         + p["gat_out"])
    enc_bwd = (obs_len * (p["embed"] + 2 * p["gru_x"] + 2 * p["gat_v"] + 2 * p["gat_agg"]
                          + 2 * p["gat_out"])
               + (2 * obs_len - 1) * p["gru_h"])
    step = p["embed"] + p["gru_x"] + p["gru_h"] + p["gat_v"] + p["gat_agg"] + p["gat_out"]
    dec_fwd = pred_len * (p["head"] + step)
    dec_bwd = pred_len * 2 * p["head"] + (pred_len - 1) * 2 * step
    bridge = 2 * H * H
    return A * (enc_fwd + enc_bwd + 3 * bridge) + G * (dec_fwd + dec_bwd)

