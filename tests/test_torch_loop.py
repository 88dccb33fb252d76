"""The port's durable epoch loop (`train/loop.py`, `train/checkpoints.py`,
`train/preemption.py`, `train/profiling.py`) against the JAX package's:
the cases of `tests/test_preemption.py` and `tests/test_checkpoints.py`
on the port, and the JAX `train_model` and the port's driven by the same
scripted losses, compared by control flow (steps saved, rolled back to
and evaluated). No log directory is given: with TensorFlow installed the
JAX `MetricWriter` writes TF events, the port's JSONL."""

import os
import signal
import threading

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pigeon_tpu.config import HeadConfig

CFG = HeadConfig(num_cells=5, embed_dim=16, smooth_labels=True)
CELLS = np.stack([np.linspace(-100, 100, 5),
                  np.linspace(-40, 40, 5)], -1).astype(np.float32)
LR = 3e-2


def arrays():
    emb = np.eye(16, dtype=np.float32)[np.arange(20) % 5]
    labels_clf = (np.arange(20) % 5).astype(np.int32)
    return {"inputs": emb, "labels": CELLS[labels_clf],
            "labels_clf": labels_clf}


def jax_world():
    """`tests/test_preemption.py::_world`: a head, AdamW and one batch."""
    from pigeon_tpu.models import GeocellHead
    from pigeon_tpu.train import create_train_state, make_eval_step, \
        make_train_step
    from pigeon_tpu.train.train_loop import adamw

    model = GeocellHead(CFG)
    opt = adamw(LR)
    state = create_train_state(jax.random.PRNGKey(0), model, opt,
                               (jnp.zeros((2, 16)),))
    step = make_train_step(model, opt, CFG, CELLS, donate=False)
    eval_step = make_eval_step(model, CFG, CELLS, num_candidates=3)
    batch = {k: jnp.asarray(v) for k, v in arrays().items()}
    return state, step, eval_step, batch


def port_world():
    """The same head from the JAX initialisation, the port's AdamW, train
    and eval steps, and the batch as numpy (the loop moves it)."""
    from pigeon_tpu_torch.models.geocell_head import GeocellHead
    from pigeon_tpu_torch.models.jax_bridge import head_state_dict_from_jax
    from pigeon_tpu_torch.train.train_loop import (
        TrainState,
        adamw,
        make_eval_step,
        make_train_step,
    )

    params = jax.tree_util.tree_map(np.asarray, jax_world()[0].params)
    model = GeocellHead(CFG)
    model.load_state_dict(head_state_dict_from_jax(params), strict=True)
    state = TrainState(model, adamw(model.parameters(), LR))
    cells = torch.from_numpy(CELLS)
    return (state, make_train_step(CFG, cells),
            make_eval_step(CFG, cells, num_candidates=3), arrays())


def to_device(batch):
    from pigeon_tpu_torch.train.train_loop import batch_to_device

    return batch_to_device(batch, "cpu")


def port_train(state, step, eval_step, batches, eval_batches, **kw):
    from pigeon_tpu_torch.train.loop import train_model

    return train_model(state, step, eval_step, batches, eval_batches,
                       batch_to_device=to_device, **kw)


def assert_states_equal(a, b):
    for x, y in zip(a.model.state_dict().values(),
                    b.model.state_dict().values()):
        assert torch.equal(x, y)
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, moments in sa["state"].items():
        for key, value in moments.items():
            assert torch.equal(value, sb["state"][i][key]), key
    assert a.step == b.step


# ---------------------------------------------------------------------------
# PreemptionGuard
# ---------------------------------------------------------------------------

def test_guard_sigterm_sets_flag_and_restores_handler():
    from pigeon_tpu_torch.train.preemption import PreemptionGuard

    prior = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert not guard.requested
        os.kill(os.getpid(), signal.SIGTERM)    # would kill, unguarded
        assert guard.requested
    assert signal.getsignal(signal.SIGTERM) is prior


def test_guard_request_without_signal():
    from pigeon_tpu_torch.train.preemption import PreemptionGuard

    guard = PreemptionGuard()
    guard.request()
    assert guard.requested


def test_guard_off_the_main_thread_is_an_inert_flag():
    from pigeon_tpu_torch.train.preemption import PreemptionGuard

    out = {}
    prior = signal.getsignal(signal.SIGTERM)

    def run():
        with PreemptionGuard() as guard:
            out["handler"] = signal.getsignal(signal.SIGTERM)
            guard.request()
            out["requested"] = guard.requested

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert out == {"handler": prior, "requested": True}


# ---------------------------------------------------------------------------
# CheckpointSession
# ---------------------------------------------------------------------------

def test_session_async_saves_then_restore(tmp_path):
    from pigeon_tpu_torch.train.checkpoints import CheckpointSession

    state, step_fn, _, batch = port_world()
    d = str(tmp_path / "ckpt")
    with CheckpointSession(d, max_to_keep=2) as sess:
        for _ in range(3):
            step_fn(state, to_device(batch))
            sess.save(state)                   # async, no wait
        assert sess.latest_step() == 3
        blank = port_world()[0]
        sess.restore(blank)                    # joins the writer first
    assert sorted(os.listdir(d)) == ["step_2", "step_3"]
    assert_states_equal(blank, state)


def test_session_restore_empty_dir_raises(tmp_path):
    from pigeon_tpu_torch.train.checkpoints import CheckpointSession

    state = port_world()[0]
    with CheckpointSession(str(tmp_path / "empty")) as sess:
        assert sess.latest_step() is None
        with pytest.raises(FileNotFoundError):
            sess.restore(state)


def test_async_save_writes_the_state_at_save(tmp_path, monkeypatch):
    """The copy is taken inside `save`: an in-place update made while the
    write is still to come does not reach the checkpoint."""
    from torch.distributed.checkpoint import FileSystemWriter

    from pigeon_tpu_torch.train.checkpoints import (
        CheckpointSession,
        read_counters,
        restore_model,
    )

    state, step_fn, _, batch = port_world()
    step_fn(state, to_device(batch))
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    release = threading.Event()
    real_write = FileSystemWriter.write_data

    def slow_write(*a, **kw):
        release.wait(10)
        return real_write(*a, **kw)

    monkeypatch.setattr(FileSystemWriter, "write_data", slow_write)
    d = str(tmp_path / "ckpt")
    with CheckpointSession(d) as sess:
        sess.save(state)
        assert sess.writing
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(1.0)                    # AdamW's in-place update
        step_fn(state, to_device(batch))
        release.set()
    assert read_counters(d)["step"] == 1
    saved = port_world()[0].model
    assert restore_model(d, saved) == 1
    for k, v in saved.state_dict().items():
        assert torch.equal(v, want[k]), k


# ---------------------------------------------------------------------------
# Preemption in train_model, the port's and the JAX package's
# ---------------------------------------------------------------------------

def sigterm_batches(batch, at):
    """4 batches an epoch; SIGTERM raised while the ``at``-th is made."""
    made = {"n": 0}

    def batches(_epoch=None):
        for _ in range(4):
            made["n"] += 1
            if made["n"] == at:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    return batches


def test_sigterm_mid_epoch_saves_and_resumes_exactly(tmp_path):
    from pigeon_tpu.train.checkpoints import latest_step as jax_latest
    from pigeon_tpu.train.loop import train_model as jax_train
    from pigeon_tpu_torch.train.checkpoints import (
        latest_step,
        restore_checkpoint,
    )

    prior = signal.getsignal(signal.SIGTERM)
    state, step_fn, eval_step, batch = port_world()
    ckpt = str(tmp_path / "ckpt")
    state, history = port_train(
        state, step_fn, eval_step, sigterm_batches(batch, 6),
        lambda: [batch], num_epochs=5, checkpoint_dir=ckpt, log_every=2,
        early_stopping_patience=50)
    assert state.step == 5                     # the 6th step never ran
    assert len(history) == 1                   # only epoch 0 reached eval
    assert latest_step(ckpt) == 5              # after epoch 0's step 4
    restored = restore_checkpoint(ckpt, port_world()[0])
    assert_states_equal(restored, state)
    assert signal.getsignal(signal.SIGTERM) is prior

    jstate, jstep, jeval, jbatch = jax_world()
    jckpt = str(tmp_path / "jax")
    jstate, jhistory = jax_train(
        jstate, jstep, jeval, sigterm_batches(jbatch, 6), lambda: [jbatch],
        num_epochs=5, rng=jax.random.PRNGKey(1), checkpoint_dir=jckpt,
        log_every=2, early_stopping_patience=50)
    assert (int(jstate.step), len(jhistory), jax_latest(jckpt)) == \
        (state.step, len(history), latest_step(ckpt))


def test_sigterm_after_last_step_skips_eval(tmp_path):
    from pigeon_tpu.train.checkpoints import latest_step as jax_latest
    from pigeon_tpu.train.loop import train_model as jax_train
    from pigeon_tpu_torch.train.checkpoints import latest_step

    def late(batch):
        def batches(_epoch=None):
            yield from [batch] * 4
            # during the loop's final pull, after the last step's poll
            os.kill(os.getpid(), signal.SIGTERM)
        return batches

    state, step_fn, eval_step, batch = port_world()
    ckpt = str(tmp_path / "ckpt")
    state, history = port_train(
        state, step_fn, eval_step, late(batch), lambda: [batch],
        num_epochs=3, checkpoint_dir=ckpt, log_every=2,
        early_stopping_patience=50)
    assert (state.step, history, latest_step(ckpt)) == (4, [], 4)

    jstate, jstep, jeval, jbatch = jax_world()
    jckpt = str(tmp_path / "jax")
    jstate, jhistory = jax_train(
        jstate, jstep, jeval, late(jbatch), lambda: [jbatch], num_epochs=3,
        rng=jax.random.PRNGKey(1), checkpoint_dir=jckpt, log_every=2,
        early_stopping_patience=50)
    assert (int(jstate.step), jhistory, jax_latest(jckpt)) == (4, [], 4)


def test_preemption_opt_out_installs_no_handler():
    state, step_fn, eval_step, batch = port_world()
    prior = signal.getsignal(signal.SIGTERM)
    seen = {}

    def batches(_epoch=None):
        seen["handler"] = signal.getsignal(signal.SIGTERM)
        return [batch]

    port_train(state, step_fn, eval_step, batches, lambda: [batch],
               num_epochs=1, preemption=False)
    assert seen["handler"] is prior


# ---------------------------------------------------------------------------
# Divergence: the same scripted losses through both loops
# ---------------------------------------------------------------------------

#: (epochs, max_recoveries, the 1-based train_step calls whose loss is
#: NaN, the error the run ends in or None).
DIVERGENCE = {
    "rollback": (3, 3, (6,), None),
    "before_first_checkpoint": (2, 3, (2,), "before the first checkpoint"),
    "max_recoveries": (4, 1, (6, 10), "diverged 2 times"),
}


def scripted(step_fn, nan_at, to_loss, record):
    """``step_fn`` with its loss replaced: NaN at the calls ``nan_at``,
    1.0 elsewhere."""
    def step(*args):
        record["calls"] += 1
        out = step_fn(*args)
        value = np.nan if record["calls"] in nan_at else 1.0
        if isinstance(out, tuple):             # the JAX step
            return out[0], dict(out[1], loss=to_loss(value))
        return dict(out, loss=to_loss(value))
    return step


def recording(cls, record):
    class Recording(cls):
        def save(self, state, *a, **kw):
            step = super().save(state, *a, **kw)
            record["saved"].append(int(step))
            return step

        def restore(self, state, *a, **kw):
            out = super().restore(state, *a, **kw)
            record["restored"].append(int(out.step))
            return out
    return Recording


def run_scripted(tmp_path, case, package, monkeypatch):
    epochs, max_recoveries, nan_at, _ = DIVERGENCE[case]
    record = {"calls": 0, "saved": [], "restored": [], "evals": []}
    if package == "jax":
        from pigeon_tpu.train import checkpoints
        from pigeon_tpu.train.loop import train_model

        monkeypatch.setattr(checkpoints, "CheckpointSession", recording(
            checkpoints.CheckpointSession, record))
        state, step_fn, eval_step, batch = jax_world()
        kw = dict(rng=jax.random.PRNGKey(1))
        to_loss = jnp.float32
    else:
        from pigeon_tpu_torch.train import loop

        monkeypatch.setattr(loop, "CheckpointSession", recording(
            loop.CheckpointSession, record))
        state, step_fn, eval_step, batch = port_world()
        kw = dict(batch_to_device=to_device)
        to_loss = torch.tensor
        train_model = loop.train_model

    def eval_batches():
        record["evals"].append(record["calls"])
        return [batch]

    try:
        train_model(state, scripted(step_fn, nan_at, to_loss, record),
                    eval_step, lambda e: [batch] * 4, eval_batches,
                    num_epochs=epochs, checkpoint_dir=str(tmp_path / package),
                    log_every=2, max_recoveries=max_recoveries,
                    early_stopping_patience=50, **kw)
        record["error"] = None
    except RuntimeError as err:
        record["error"] = str(err)
    return record


@pytest.mark.parametrize("case", sorted(DIVERGENCE))
def test_divergence_follows_the_jax_loop(tmp_path, monkeypatch, case):
    got = run_scripted(tmp_path, case, "port", monkeypatch)
    want = run_scripted(tmp_path, case, "jax", monkeypatch)
    assert got == want
    error = DIVERGENCE[case][3]
    if error is None:
        assert got["error"] is None
        assert got["restored"] == [4]          # epoch 0's checkpoint
        assert got["evals"] == [4, 10]         # epoch 1 never evaluated
    else:
        assert error in got["error"]


def test_divergence_without_a_checkpoint_dir_raises():
    state, step_fn, eval_step, batch = port_world()
    record = {"calls": 0}
    with pytest.raises(RuntimeError, match="no checkpoint to roll back"):
        port_train(state, scripted(step_fn, (2,), torch.tensor, record),
                   eval_step, lambda e: [batch] * 4, lambda: [batch],
                   num_epochs=1, log_every=2)


# ---------------------------------------------------------------------------
# The profiler window
# ---------------------------------------------------------------------------

def test_profiler_window_writes_a_trace_the_summary_reads(tmp_path, capsys):
    from pigeon_tpu_torch.train import profiling

    d = str(tmp_path / "profile")
    window = profiling.ProfilerWindow(d)
    assert (window.wait, window.active) == (4, 10)
    x = torch.randn(64, 64)
    for _ in range(14):
        window.step()
        torch.mm(x, x)
    window.step()                              # the 15th closes it
    assert window.path is not None and os.path.exists(window.path)
    rows = profiling.summarize_trace(d, include_host=True)
    assert any(name == "aten::mm" and ms > 0 for name, ms, _ in rows)
    assert 0 < sum(pct for _, _, pct in rows) <= 100 + 1e-9
    if not torch.cuda.is_available():
        # No device ran: the summary says so, never zero device time.
        with pytest.raises(profiling.NoDeviceRecords):
            profiling.summarize_trace(d)
        profiling.print_trace_summary(d)
        assert "not measured" in capsys.readouterr().out
    window.close()                             # closed already: no-op
    one_off = str(tmp_path / "capture")
    assert profiling.capture_trace(lambda: torch.mm(x, x), one_off) == one_off
    assert any(name == "aten::mm" for name, _, _ in
               profiling.summarize_trace(one_off, include_host=True))


def test_profile_dir_reaches_the_window(tmp_path):
    state, step_fn, eval_step, batch = port_world()
    d = str(tmp_path / "profile")
    port_train(state, step_fn, eval_step, lambda e: [batch] * 8,
               lambda: [batch], num_epochs=2, profile_dir=d)
    assert len(os.listdir(d)) == 1             # steps 5-14 of 16
    assert state.step == 16
