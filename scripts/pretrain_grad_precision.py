#!/usr/bin/env python3
"""How far bf16 pretraining gradients sit from f32 ones, route by route.

    python3 scripts/pretrain_grad_precision.py [--batch 32] [--seed 0]

One contrastive micro-batch of the full-width `CLIPModel` (ViT-L/14-336
vision with remat ``attn_kernel``, ViT-L/14 text) on seeded N(0, 1)
pixels and token ids, its vision gradients taken four ways: the kernel
route (K1 forward, K2 backward) twice, the plain route in bf16 and the
plain route in f32. For each pair it prints the cosine of the whole vision
gradient, the worst tensors' cosines with the reference's norm, and how
many tensors fall below 0.999. Needs a CUDA device; the kernels are built
at first use.
"""

import argparse
import subprocess
import sys

import torch


def vision_grads(model, pixels, ids, route: str, dtype) -> dict:
    """The vision tower's gradients of one contrastive micro-batch on
    ``route`` with compute in ``dtype``, flattened, in f32."""
    from pigeon_tpu_torch.models.clip import set_route

    set_route(model.vision, route)
    for m in (model, model.vision, model.text):
        m.dtype = dtype
    model.zero_grad(set_to_none=True)
    model(pixels, ids, return_loss=True)["loss"].backward()
    out = {n: p.grad.float().flatten().clone()
           for n, p in model.vision.named_parameters()}
    model.zero_grad(set_to_none=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("pretrain_grad_precision: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)

    from pigeon_tpu_torch.config import pigeon_config
    from pigeon_tpu_torch.models.clip import CLIPModel
    from pigeon_tpu_torch.models.super_guessr import init_weights

    cfg = pigeon_config()
    eos = cfg.text.vocab_size - 1
    model = init_weights(CLIPModel(cfg.vision, cfg.text, dtype=torch.bfloat16,
                                   eos_token_id=eos, remat="attn_kernel"),
                         cfg.train.pretrain_seed).cuda()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    size = cfg.vision.image_size
    pixels = torch.randn(args.batch, size, size, 3, device="cuda",
                         generator=gen)
    ids = torch.randint(0, eos - 2, (args.batch, 77), device="cuda",
                        generator=gen)
    ids[:, 20:] = eos
    runs = {name: vision_grads(model, pixels, ids, route, dtype)
            for name, route, dtype in (
                ("kernel", "fused", torch.bfloat16),
                ("kernel_again", "fused", torch.bfloat16),
                ("plain", "plain", torch.bfloat16),
                ("plain_f32", "plain", torch.float32))}
    cos = torch.nn.functional.cosine_similarity
    for a, b in (("kernel", "kernel_again"), ("kernel", "plain"),
                 ("kernel", "plain_f32"), ("plain", "plain_f32")):
        per = {n: cos(runs[a][n], runs[b][n], dim=0).item() for n in runs[a]}
        worst = sorted(per, key=per.get)[:5]
        whole = cos(torch.cat(list(runs[a].values())),
                    torch.cat(list(runs[b].values())), dim=0).item()
        print(f"{a} vs {b}: whole={whole:.7f} "
              f"below_0.999={sum(c < 0.999 for c in per.values())} "
              f"of {len(per)} worst="
              f"{[(n, round(per[n], 6), float(runs[b][n].norm())) for n in worst]}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
