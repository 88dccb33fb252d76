"""The plain float32 reference that decides ``correct``.

Plain PyTorch operations from the published descriptions (CLIP's vision
transformer, PIGEON's panorama head, haversine label smoothing, AdamW,
ProtoNet refinement), with TF32 off. It imports nothing of the program
and takes only what the benchmark makes: weights and inputs from the
seed, and the program's outputs to judge them.
"""
