"""The port's `adamw` (`train/train_loop.py`) against optax's chain of the
JAX wrapper, `clip_by_global_norm` and `MultiSteps`, over 6 steps of
seeded gradients, and its accumulation inside a train step and across a
state dict."""

import numpy as np
import pytest
import torch

SHAPES = ((5, 3), (7,), (2, 2, 2))
STEPS = 6


def grads(seed=9, scale=1.0):
    rng = np.random.default_rng(seed)
    return [[(rng.normal(size=s) * scale).astype(np.float32) for s in SHAPES]
            for _ in range(STEPS)]


def init(seed=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in SHAPES]


CASES = {
    "plain": dict(),
    "clip": dict(max_grad_norm=1.0),
    "clip_loose": dict(max_grad_norm=100.0),
    "accum_2": dict(accum_steps=2),
    "accum_4_clip": dict(accum_steps=4, max_grad_norm=0.5),
    "pretrain": dict(b1=0.9, b2=0.98, eps=1e-6, weight_decay=1e-3,
                     max_grad_norm=1.0, accum_steps=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_adamw_matches_optax(case):
    import jax.numpy as jnp

    from pigeon_tpu.train.train_loop import adamw as jax_adamw
    from pigeon_tpu_torch.train.train_loop import adamw

    kw = CASES[case]
    lr = 1e-2
    tx = jax_adamw(lr, **kw)
    jparams = [jnp.asarray(p) for p in init()]
    opt_state = tx.init(jparams)
    params = [torch.nn.Parameter(torch.from_numpy(p)) for p in init()]
    opt = adamw(params, lr, **kw)
    for step, gs in enumerate(grads(scale=3.0)):
        updates, opt_state = tx.update([jnp.asarray(g) for g in gs],
                                       opt_state, jparams)
        jparams = [p + u for p, u in zip(jparams, updates)]
        for p, g in zip(params, gs):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        for got, want in zip(params, jparams):
            # 1e-6: f32 rounding of the two formulas of the same update.
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), atol=1e-6,
                                       rtol=0, err_msg=f"step {step}")


def test_accumulation_counts_every_micro_step_and_resumes():
    """``TrainState.step`` counts every micro-step; the parameters move on
    every second; a state dict taken between updates carries the running
    mean, so a restored optimizer continues exactly."""
    from pigeon_tpu_torch.train.train_loop import TrainState, adamw

    def make():
        model = torch.nn.Linear(3, 2)
        torch.manual_seed(0)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.randn_like(p))
        return TrainState(model, adamw(model.parameters(), 1e-2,
                                       accum_steps=2))

    x = torch.randn(4, 3, generator=torch.Generator().manual_seed(1))

    def step(state):
        state.optimizer.zero_grad(set_to_none=True)
        state.model(x * (state.step + 1)).square().sum().backward()
        state.optimizer.step()
        state.step += 1

    state = make()
    before = [p.detach().clone() for p in state.model.parameters()]
    step(state)
    assert all(torch.equal(a, b) for a, b in
               zip(before, state.model.parameters()))
    assert state.step == 1 and state.optimizer.mini_step == 1
    saved = state.optimizer.state_dict()
    other = make()
    other.step = 1
    other.optimizer.load_state_dict(saved)
    for s in (state, other):
        step(s)
        step(s)
        step(s)
    assert state.step == other.step == 4
    for a, b in zip(state.model.parameters(), other.model.parameters()):
        assert torch.equal(a, b)
    assert not any(torch.equal(a, b) for a, b in
                   zip(before, state.model.parameters()))


def test_default_adamw_keeps_torchs_state_dict():
    """Without accumulation the state dict is torch AdamW's own, which the
    checkpoints and the Orbax converter read."""
    from pigeon_tpu_torch.train.train_loop import adamw

    p = torch.nn.Parameter(torch.ones(3))
    opt = adamw([p], 1e-3)
    p.grad = torch.ones(3)
    opt.step()
    assert sorted(opt.state_dict()) == ["param_groups", "state"]
    with pytest.raises(ValueError, match="accum_steps"):
        adamw([p], 1e-3, accum_steps=0)
