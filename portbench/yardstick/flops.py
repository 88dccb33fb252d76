"""Operations and bytes from shapes, and the published peaks of one H100.

Peaks: NVIDIA's data sheet for the H100 SXM, dense rates at the 700 W
power limit. A matrix product of (m, k) by (k, n) is ``2 m k n``
operations; element-wise work (LayerNorm, GELU, softmax, residuals) is
not counted. A roofline's bound is the larger of its operations over the
peak rate and its bytes over the memory bandwidth, with each input byte
read once and each output byte written once.
"""

from __future__ import annotations

#: bf16 and fp16 tensor-core rate, int8 rate, float32 outside the tensor
#: cores, and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12
#: The head width of K1 and K2.
HEAD_DIM = 64
BF16_BYTES = 2


def seq_len(vision: dict) -> int:
    """Tokens a view: the patches and the class token."""
    return (vision["image_size"] // vision["patch_size"]) ** 2 + 1


def patch_embed_flops(vision: dict) -> float:
    """The patch embedding's product for one view."""
    p, c = vision["patch_size"], vision.get("num_channels", 3)
    return 2.0 * (seq_len(vision) - 1) * p * p * c * vision["hidden_size"]


def layer_linear_flops(vision: dict) -> float:
    """One encoder layer's dense products for one view: q, k, v, the
    output projection, fc1 and fc2."""
    s, d, i = seq_len(vision), vision["hidden_size"], \
        vision["intermediate_size"]
    return 2.0 * s * d * (4 * d + 2 * i)


def layer_attention_flops(vision: dict) -> float:
    """One encoder layer's two attention products (``q k^T`` and ``p v``)
    for one view, over all heads."""
    s, d = seq_len(vision), vision["hidden_size"]
    return 4.0 * s * s * d


def tower_forward_flops(vision: dict) -> float:
    """The vision tower's forward for one view."""
    per_layer = layer_linear_flops(vision) + layer_attention_flops(vision)
    return patch_embed_flops(vision) + vision["num_hidden_layers"] * per_layer


def head_forward_flops(head: dict, embed_dim: int) -> float:
    """The geocell head's products for one sample (a panorama's views are
    averaged first): the cell layer and the multi-task layers."""
    outs = head["num_cells"]
    if head.get("multi_task"):
        outs += head["num_mt_vars"] + head["num_climates"]
        if head.get("predict_month"):
            outs += head["num_months"]
    return 2.0 * embed_dim * outs


def tower_backward_flops(vision: dict, trained_layers: int) -> float:
    """The tower's backward for one view when the patch embedding and the
    last ``trained_layers`` encoder layers train: the input gradient of
    every layer (each dense product once more, the attention's four
    products), and the weight gradients of the trained layers and of the
    patch embedding. Recomputation under remat is not counted."""
    layers = vision["num_hidden_layers"]
    input_grads = layers * (layer_linear_flops(vision)
                            + 2 * layer_attention_flops(vision))
    weight_grads = trained_layers * layer_linear_flops(vision)
    return input_grads + weight_grads + patch_embed_flops(vision)


def train_flops_per_view(vision: dict, head: dict, views: int,
                         trained_layers: int) -> float:
    """One view's share of a train step: the tower's forward and backward,
    and a ``views``-th of the head's forward, input and weight
    gradients."""
    d = vision["hidden_size"]
    return (tower_forward_flops(vision)
            + tower_backward_flops(vision, trained_layers)
            + 3.0 * head_forward_flops(head, d) / views)


def k1_ops_bytes(b: int, s: int, d: int, heads: int) -> tuple:
    """K1 (fused q/k/v projection and attention) on x (b, s, d): the
    projection's and the attention's operations, and the bytes of x, the
    three weights and biases and the (b, s, P) output."""
    p = heads * HEAD_DIM
    ops = 2.0 * b * s * d * 3 * p + 4.0 * b * heads * s * s * HEAD_DIM
    nbytes = BF16_BYTES * (b * s * d + 3 * p * d + 3 * p + b * s * p)
    return ops, nbytes


def k2_ops_bytes(b: int, s: int, d: int, heads: int) -> tuple:
    """K2 (K1's backward) on x (b, s, d) and the cotangent g (b, s, P):
    the projection recomputed, the attention backward (``q k^T`` again,
    ``g v^T``, ``p^T g``, ``ds k`` and ``ds^T q``) and the dx product;
    the bytes of x, g, the weights and biases, and dx, dq, dk, dv."""
    p = heads * HEAD_DIM
    proj = 2.0 * b * s * d * 3 * p
    attn = 10.0 * b * heads * s * s * HEAD_DIM
    ops = 2 * proj + attn
    nbytes = BF16_BYTES * (2 * b * s * d + 2 * b * s * p + 3 * p * d + 3 * p
                           + 3 * b * s * p)
    return ops, nbytes


def bound_seconds(ops: float, nbytes: float,
                  peak_ops: float = PEAK_BF16_FLOPS,
                  peak_bytes: float = PEAK_HBM_BYTES_PER_S) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(ops / peak_ops, nbytes / peak_bytes)
