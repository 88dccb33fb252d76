"""pigeon_tpu_torch — the PIGEON geolocation system in PyTorch, for one
NVIDIA H100.

A port of `pigeon_tpu` (JAX on a TPU), which stays beside it as the
reference the port is tested against. The layout mirrors `pigeon_tpu`
module for module; inside, the code is PyTorch's own idiom: `nn.Module`s,
plain tensor functions with an explicit device, seeded
`torch.Generator`s, Python loops where JAX used `scan`.

This package imports ``torch`` and never ``jax``. It shares the
dataclass presets of `pigeon_tpu.config`, whose import chain is free of
JAX.

Layout:
    core/     geodesy (haversine, torch and float64 numpy) and scoring
              (label smoothing, the GeoGuessr score)
    kernels/  hand-written CUDA kernels with their plain PyTorch versions:
              fused QKV attention forward (K1) and backward (K2) as one
              autograd Function, attention on separate q/k/v (K3), int8
              fused QKV attention (K8), haversine label smoothing (K10)
    csrc/     the kernels' CUDA C++ sources (nvcc, sm_90a, ctypes-bound)
    models/   CLIP vision tower (with the training remat policy and the
              int8 layers of models/quant.py), geocell head and its
              loss, SuperGuessr, proto refiner, and the weight bridge
              from JAX parameter trees
    data/     uint8 image decode/resize, device-side normalisation, and
              the CSV image pipeline for training
    geocell/  boundary polygons (the country lookup) and the GeoAugmentor
    train/    refiner presets, the finetune model builder, train and eval
              steps, AdamW, the durable epoch loop (rollback, preemption,
              async checkpoints, the profiler window), metrics
    serve/    the HTTP server speaking the Chrome-extension bot protocol
    cli/      ``python -m pigeon_tpu_torch.cli.run {serve,finetune,
              evaluate,predict,embed,augment} ...``
"""

__version__ = "0.1.0"
