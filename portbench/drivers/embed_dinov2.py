"""The embedding sweep of ``embed --model dinov2-g14-reg``:
`train.embed.make_embed_step` over a DINOv2 `models.vit_embedder.ViTEmbedder`
(SwiGLU, LayerScale, 4 registers; the final-LN CLS row), batch after
batch.

The window, the sample and the read-back are `drivers.embed`'s: a pool of
``pool`` seeded uint8 batches on the host, each crossing to the card in
the step, its embeddings read after the next batch is enqueued. This
driver builds the DINOv2 tower from the configuration file (on ``meta``,
loaded from one seeded draw on the card, `make_weights`), counts its
FLOPs by `yardstick.dinov2.forward_flops`, reports the calls of K1 and of
the two kernels the DINOv2 layer adds (`kernels/eltwise.py`
``swiglu_bf16`` and ``scale_add_layer_norm_bf16``, from their launch
counters) in the traced slice, with their trace groups added from set-up
to release (`yardstick.dinov2.add_groups`), and checks against
`reference.dinov2`.

The check: as `drivers.embed`'s, the reference embedding ``checked_rows``
rows drawn from the seed in float32. ``control`` judges the reference on
fp8 e4m3 operands (`reference.model.fake_fp8`) in place of the program's
answers: the ViT has no int8 twin.

Faults (for the correctness tooling): ``half_batch`` and ``altered`` as
`drivers.embed`'s; ``no_layer_scale``, the program's LayerScale set to
one; ``no_registers``, the program's registers left out; ``clip_norm``,
the program's pixels normalised by CLIP's constants.
"""

from __future__ import annotations

import math

import torch

from portbench import inputs, program
from portbench.drivers import embed
from portbench.yardstick import dinov2 as arith

FAULTS = (None, "half_batch", "altered", "no_layer_scale", "no_registers",
          "clip_norm")


def weight_specs(cfg: dict) -> list:
    """``(name, shape, scale, shift)`` of every normal parameter of the
    DINOv2 `ViTEmbedder`, by its state-dict names, in a fixed order: a
    tensor is ``shift + scale * N(0, 1)``. Dense and patch weights have
    variance ``1 / fan_in``; biases, the class token, the registers and
    the positions N(0, 0.02^2); LayerNorm scales 1 + N(0, 0.02^2). The
    LayerScale vectors are `gamma_names`."""
    d, i = cfg["hidden_size"], arith.swiglu_width(cfg)
    p, c = cfg["patch_size"], cfg.get("num_channels", 3)
    specs = []

    def dense(name, n_out, n_in):
        specs.append((f"{name}.weight", (n_out, n_in), n_in ** -0.5, 0.0))
        specs.append((f"{name}.bias", (n_out,), 0.02, 0.0))

    def norm(name):
        specs.append((f"{name}.weight", (d,), 0.02, 1.0))
        specs.append((f"{name}.bias", (d,), 0.02, 0.0))

    dense("patch_embed", d, p * p * c)
    specs.append(("cls_token", (d,), 0.02, 0.0))
    specs.append(("pos_embed", (arith.seq_len(cfg)
                                - cfg["num_register_tokens"], d), 0.02, 0.0))
    specs.append(("register_tokens", (cfg["num_register_tokens"], d), 0.02,
                  0.0))
    for layer in range(cfg["num_hidden_layers"]):
        base = f"encoder.layers.{layer}."
        norm(base + "ln1")
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(base + "attn." + proj, d, d)
        norm(base + "ln2")
        dense(base + "w_in", 2 * i, d)
        dense(base + "w_out", d, i)
    norm("final_ln")
    return specs


def gamma_names(cfg: dict) -> list:
    return [f"encoder.layers.{layer}.gamma{k}"
            for layer in range(cfg["num_hidden_layers"]) for k in (1, 2)]


#: LayerScale's per-channel draw: uniform in this range, so that a gamma
#: dropped, transposed or broadcast wrongly moves the embedding.
GAMMA_RANGE = (0.05, 1.0)


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The f32 weights from one normal draw of ``seed`` on ``device`` and
    one uniform draw for the LayerScale vectors."""
    specs = weight_specs(cfg)
    total = sum(torch.Size(shape).numel() for _, shape, _, _ in specs)
    flat = torch.randn(total, device=device, generator=inputs.generator(
        seed, "dinov2.weights", device))
    out, offset = {}, 0
    for name, shape, scale, shift in specs:
        n = torch.Size(shape).numel()
        out[name] = flat[offset:offset + n].view(shape).mul(scale).add(shift)
        offset += n
    del flat
    names, d = gamma_names(cfg), cfg["hidden_size"]
    lo, hi = GAMMA_RANGE
    gammas = torch.rand((len(names), d), device=device,
                        generator=inputs.generator(seed, "dinov2.gamma",
                                                   device))
    for name, g in zip(names, lo + (hi - lo) * gammas):
        out[name] = g
    return out


def vision_config(cfg: dict):
    """The port's `VisionConfig` for the configuration file."""
    from pigeon_tpu_torch.config import VisionConfig

    return VisionConfig(
        image_size=cfg["image_size"], patch_size=cfg["patch_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=arith.swiglu_width(cfg),
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        projection_dim=cfg["hidden_size"],
        layer_norm_eps=cfg["layer_norm_eps"], hidden_act=cfg["hidden_act"])


def variant(cfg: dict, fault=None):
    """The port's `ViTVariant` for the configuration file (CLIP's pixel
    normalisation under the ``clip_norm`` fault)."""
    from pigeon_tpu_torch.config import ViTVariant

    norm = {} if fault == "clip_norm" else dict(
        pixel_mean=tuple(cfg["image_mean"]), pixel_std=tuple(cfg["image_std"]))
    return ViTVariant(mlp="swiglu" if cfg["use_swiglu_ffn"] else "gelu",
                      layer_scale=True,
                      num_register_tokens=cfg["num_register_tokens"], **norm)


def _launches() -> dict:
    """K1's launch counter and the two DINOv2 kernels'."""
    from pigeon_tpu_torch.kernels import eltwise

    counts = program.launches()
    counts["swiglu"] = eltwise.swiglu_bf16.launches
    counts["scale_add_ln"] = eltwise.scale_add_layer_norm_bf16.launches
    return counts


class Driver(embed.Driver):
    def __init__(self, config, traffic, seed, device, fault=None,
                 control=False):
        if fault not in FAULTS:
            raise ValueError(f"embed_dinov2 driver: no fault {fault!r}")
        super().__init__(config, traffic, seed, device)
        self.fault, self.control = fault, control

    def setup(self):
        from pigeon_tpu_torch.models.vit_embedder import ViTEmbedder
        from pigeon_tpu_torch.train.embed import make_embed_step

        cfg = self.cfg
        self.groups = arith.add_groups()
        vision, var = vision_config(cfg), variant(cfg, self.fault)
        model = program.build(lambda: ViTEmbedder(
            vision, dtype=program.dtype(cfg), pool="cls",
            attn_impl=program.route(cfg), variant=var), self.device)
        weights = make_weights(cfg, self.seed, self.device)
        program.load(model, weights)
        del weights
        with torch.no_grad():
            if self.fault == "no_layer_scale":
                for name in gamma_names(cfg):
                    model.get_parameter(name).fill_(1.0)
        if self.fault == "no_registers":
            model.register_tokens = None
        model.eval()
        self.pool = [self._pixels(j).cpu().numpy()
                     for j in range(self.traffic["pool"])]
        self.model = model
        self.step = make_embed_step(model, self.device)
        # Warm-up: every batch of the pool once, the last read back.
        self._run(0.0, min_batches=len(self.pool), keep=False)

    def release(self):
        super().release()
        arith.restore_groups(self.groups)

    def window(self, seconds: float) -> dict:
        batches, bad, elapsed = self._run(seconds)
        return {"attempted": batches, "failed": bad,
                "items": batches * self.batch, "seconds": elapsed,
                "flops_per_item": arith.forward_flops(self.cfg)}

    def slice(self) -> dict:
        before = _launches()
        self._run(self.traffic["trace_seconds"], keep=False)
        after = _launches()
        rows = self.batch * arith.seq_len(self.cfg)
        d = self.cfg["hidden_size"]
        shapes = {"K1": (self.batch, arith.seq_len(self.cfg), d,
                         self.cfg["num_attention_heads"]),
                  "swiglu": (rows, arith.swiglu_width(self.cfg)),
                  "scale_add_ln": (rows, d)}
        return {k: [(shapes[k], after[k] - before[k])] for k in shapes
                if after.get(k, 0) > before.get(k, 0)}

    def check(self) -> dict:
        from portbench.reference import dinov2 as ref

        ref.highest_precision()
        w = make_weights(self.cfg, self.seed, self.device)
        worst = 0.0
        block = self.traffic["reference_block"]
        for i in range(0, len(self.keys), block):
            where = self.where[i:i + block]
            px = torch.stack([torch.from_numpy(self.pool[j][r])
                              for j, r in where]).to(self.device)
            want = ref.embed(w, self.cfg, px, block=block)
            if self.control:
                got = ref.embed(w, self.cfg, px, block=block, fp8=True)
            else:
                got = torch.from_numpy(self.answers[i:i + block]) \
                    .to(want.device).float()
            err = ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
            worst = max(worst, err if math.isfinite(err) else math.inf)
        return {"embedding_error": worst}
