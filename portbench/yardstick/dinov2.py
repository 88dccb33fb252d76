"""DINOv2's arithmetic for the benchmark: the model FLOPs of one image,
the bytes of the two element-wise kernels its layer adds to the port
(`kernels/eltwise.py` `swiglu_bf16` and `scale_add_layer_norm_bf16`), and
their kernel groups in a trace.

The DINOv2 driver adds the groups to `trace.KERNEL_GROUPS` for its run
(`add_groups` in its set-up, `restore_groups` in its release): their
marks are the two kernels' own tags, which no kernel of the other cells
carries, and no other driver's run sees them. Each roofline is the
kernels' bytes bound over the device time of their group; a slice whose
trace holds fewer records of a group than the kernel launched reads
nothing.
"""

from __future__ import annotations

from portbench.yardstick import flops, trace

#: Each new kernel: its group in a trace and the mark of its CUDA name.
GROUPS = {"swiglu": ("SwiGLU", "EltSwiGlu"),
          "scale_add_ln": ("scale-add LN", "EltScaleAddLayerNorm")}


def add_groups() -> tuple:
    """Append the two kernels' groups to `trace.KERNEL_GROUPS`; returns
    the groups as they were, for `restore_groups`."""
    before = trace.KERNEL_GROUPS
    trace.KERNEL_GROUPS = before + tuple(GROUPS.values())
    return before


def restore_groups(before: tuple) -> None:
    trace.KERNEL_GROUPS = before


def seq_len(cfg: dict) -> int:
    """Tokens an image: the CLS token, the registers and the patches."""
    return (1 + cfg["num_register_tokens"]
            + (cfg["image_size"] // cfg["patch_size"]) ** 2)


def swiglu_width(cfg: dict) -> int:
    """HF's SwiGLU hidden width for the configuration."""
    return (int(cfg["hidden_size"] * cfg["mlp_ratio"] * 2 / 3) + 7) // 8 * 8


def forward_flops(cfg: dict) -> float:
    """One image's forward: the patch embedding, and in each layer the
    q/k/v and output projections and the SwiGLU MLP (``W_in`` to ``2I``,
    ``W_out`` from ``I``), ``2 S D (4 D + 3 I)``, and the attention's two
    products, ``4 S^2 D``. Element-wise work is not counted."""
    s, d, i = seq_len(cfg), cfg["hidden_size"], swiglu_width(cfg)
    p, c = cfg["patch_size"], cfg.get("num_channels", 3)
    patches = (cfg["image_size"] // p) ** 2
    layer = 2.0 * s * d * (4 * d + 3 * i) + 4.0 * s * s * d
    return 2.0 * patches * p * p * c * d + cfg["num_hidden_layers"] * layer


def swiglu_ops_bytes(rows: int, inter: int) -> tuple:
    """`swiglu_bf16` on ``(rows, 2I)``: no counted operations; the bytes
    of its input and its ``(rows, I)`` output."""
    return 0.0, flops.BF16_BYTES * rows * 3 * inter


def scale_add_ln_ops_bytes(rows: int, d: int) -> tuple:
    """`scale_add_layer_norm_bf16` on ``(rows, D)``: no counted
    operations; the bytes of x, a, the sum and LN(sum), and of gamma and
    the LN parameters (f32)."""
    return 0.0, flops.BF16_BYTES * rows * 4 * d + 4 * 3 * d


OPS_BYTES = {"swiglu": swiglu_ops_bytes,
             "scale_add_ln": scale_add_ln_ops_bytes}


def roofline(run, kernel: str):
    """The bytes bound of the kernel's calls in the traced slice over its
    group's device time, as a percentage; None where the slice has no
    call, or fewer trace records than launches."""
    calls = run.calls.get(kernel)
    if run.trace is None or not calls:
        return None
    label = GROUPS[kernel][0]
    seconds = run.trace.group_seconds.get(label, 0.0)
    if seconds <= 0 or run.trace.group_records.get(label, 0) < sum(
            n for _, n in calls):
        return None
    bound = sum(n * flops.bound_seconds(*OPS_BYTES[kernel](*shape))
                for shape, n in calls)
    return 100.0 * bound / seconds
