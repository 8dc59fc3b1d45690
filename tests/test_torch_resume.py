"""The port's durable training: the token stream against the reference's,
the atomic CheckpointManager (rotation, torn-checkpoint fallback),
TrainLoop kill/resume and SIGTERM salvage (bitwise on the CPU), and
checkpoint interop with the JAX package in both directions, bitwise.
A bf16 leaf round-trips without ``ml_dtypes``, which the machine with the
card does not have."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import load_checkpoint as jax_load  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.checkpoint.io import _flatten as jax_flatten  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.data.tokens import SeekableTokenBatches as JaxBatches  # noqa: E402
from repro.data.tokens import lm_batch_iterator as jax_iterator  # noqa: E402
from repro.launch.train import train_main as jax_train_main  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import init_train_state as jax_init_state  # noqa: E402
from repro_torch.checkpoint import (CheckpointError,  # noqa: E402
                                    CheckpointManager, list_checkpoints,
                                    load_checkpoint, read_manifest,
                                    save_checkpoint)
from repro_torch.checkpoint.io import _flatten  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.data.tokens import (SeekableTokenBatches,  # noqa: E402
                                     lm_batch_iterator)
from repro_torch.launch.train import train_main  # noqa: E402
from repro_torch.models.model import period_len  # noqa: E402
from repro_torch.train import (Preemption, TrainLoop,  # noqa: E402
                               TrainState, init_train_state)

ROOT = Path(__file__).resolve().parents[1]
KW = dict(batch=2, seq=16, log_every=0, seed=0, device="cpu")


def _subproc_env(**extra):
    env = dict(os.environ)
    src = str(ROOT / "src")
    existing = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = src + (os.pathsep + existing if existing else "")
    env.update(extra)
    return env


# ------------------------------------------------------------ token stream
def test_token_stream_matches_reference():
    ours, ref = SeekableTokenBatches(512, 2, 16, 3), JaxBatches(512, 2, 16, 3)
    for _ in range(3):
        for a, b in zip(ours.next_batch(), ref.next_batch()):
            np.testing.assert_array_equal(a, b)
    cur = json.loads(json.dumps(ours.cursor()))
    assert cur == json.loads(json.dumps(ref.cursor()))
    want = [ref.next_batch() for _ in range(2)]
    fresh = SeekableTokenBatches(512, 2, 16, 3)
    fresh.seek(cur)
    for got, exp in zip([fresh.next_batch() for _ in range(2)], want):
        for a, b in zip(got, exp):
            np.testing.assert_array_equal(a, b)
    # replay seek (a bare step cursor) and the iterator's start_step
    replay = SeekableTokenBatches(512, 2, 16, 3)
    replay.seek({"step": 3})
    np.testing.assert_array_equal(replay.next_batch()[0], want[0][0])
    np.testing.assert_array_equal(next(lm_batch_iterator(64, 2, 8, 1, 4))[0],
                                  next(jax_iterator(64, 2, 8, 1, 4))[0])


# ------------------------------------------------------- CheckpointManager
def _toy_state(value=1.0, step=0):
    return TrainState({"w": torch.full((4,), value)}, {}, step)


def test_manager_atomic_layout_and_rotation(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", keep_last=2, every_steps=1,
                            async_saves=False)
    for step in (1, 2, 3, 4):
        mgr.save(_toy_state(float(step), step), step,
                 extra={"data_cursor": {"step": step}})
    assert [s for s, _ in list_checkpoints(tmp_path / "ck")] == [3, 4]
    assert not [p for p in (tmp_path / "ck").iterdir()
                if p.name.startswith(".tmp")]
    state, step, extra = mgr.restore_latest(like=_toy_state())
    assert step == 4 and state.step == 4
    assert extra["data_cursor"] == {"step": 4}
    assert torch.equal(state.params["w"], torch.full((4,), 4.0))


def test_manager_async_snapshot_is_a_copy(tmp_path):
    """The step updates tensors in place right after ``save`` returns; the
    background writer must still publish the values at save time."""
    mgr = CheckpointManager(tmp_path / "ck", every_steps=2, async_saves=True)
    state = _toy_state(2.0)
    assert not mgr.maybe_save(state, 1)
    assert mgr.maybe_save(state, 2)
    state.params["w"].add_(5.0)                  # the next in-place step
    mgr.wait()
    got, step, _ = mgr.restore_latest(like=_toy_state())
    assert step == 2 and torch.equal(got.params["w"], torch.full((4,), 2.0))
    assert mgr.stats()["saves"] == 1 and mgr.stats()["async"]
    mgr.close()


@pytest.mark.parametrize("tear", ["truncated_manifest", "missing_manifest",
                                  "torn_shard"])
def test_manager_falls_back_past_torn_checkpoint(tmp_path, tear):
    mgr = CheckpointManager(tmp_path / "ck", keep_last=3, async_saves=False)
    mgr.save(_toy_state(1.0, 5), 5)
    mgr.save(_toy_state(9.0, 10), 10)
    newest = tmp_path / "ck" / "step_00000010"
    manifest = newest / "manifest.json"
    if tear == "truncated_manifest":
        manifest.write_text(manifest.read_text()[:20])
    elif tear == "missing_manifest":
        manifest.unlink()
    else:
        shard = newest / "shard_0000.npz"
        shard.write_bytes(shard.read_bytes()[:40])
    state, step, _ = mgr.restore_latest(like=_toy_state())
    assert step == 5 and torch.equal(state.params["w"], torch.ones(4))
    assert "step_00000010" in mgr.restore_skipped[0]
    with pytest.raises(CheckpointError):
        load_checkpoint(newest)
    assert CheckpointManager(tmp_path / "none").restore_latest(
        like=_toy_state()) is None


def test_load_checkpoint_checks_shapes_and_casts_dtypes(tmp_path):
    save_checkpoint(tmp_path / "ck", {"w": torch.arange(6.0).reshape(2, 3)})
    tree, _ = load_checkpoint(tmp_path / "ck",
                              like={"w": torch.zeros(2, 3, dtype=torch.bfloat16)})
    assert tree["w"].dtype == torch.bfloat16
    assert torch.equal(tree["w"].float(), torch.arange(6.0).reshape(2, 3))
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(tmp_path / "ck", like={"w": torch.zeros(3, 2)})
    with pytest.raises(KeyError, match="missing"):
        load_checkpoint(tmp_path / "ck", like={"v": torch.zeros(2, 3)})


# ------------------------------------------------------ TrainLoop kill/resume
def _final_arrays(ck_dir):
    flat, step = load_checkpoint(list_checkpoints(ck_dir)[-1][1])
    return flat, step


def _assert_same_arrays(got, want):
    assert set(got) == set(want) and want
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_trainloop_preempt_then_resume_bitwise(tmp_path):
    base = train_main("stablelm-1.6b", steps=10, checkpoint_dir=str(
        tmp_path / "oracle"), checkpoint_async=False, **KW)
    ck = str(tmp_path / "ck")
    with pytest.raises(Preemption):
        train_main("stablelm-1.6b", steps=10, checkpoint_dir=ck,
                   checkpoint_every=3, preempt_at_step=7, **KW)
    res = train_main("stablelm-1.6b", steps=10, checkpoint_dir=ck,
                     checkpoint_every=3, resume=True, **KW)
    assert res["resumed_from_step"] == 6 and res["steps"] == 10
    assert res["losses"] == base["losses"][6:]          # bitwise on CPU
    got, step = _final_arrays(ck)
    want, wstep = _final_arrays(tmp_path / "oracle")
    assert step == wstep == 10
    _assert_same_arrays(got, want)
    keys = read_manifest(list_checkpoints(ck)[-1][1])["keys"]
    assert any(k.startswith("opt_state/m/") for k in keys) and "step" in keys


def test_trainloop_fault_hook_and_resume_without_checkpoint():
    seen = []

    def hook(i):
        seen.append(i)
        if i == 2:
            raise KeyboardInterrupt

    class Data:
        def next_batch(self):
            return None

    loop = TrainLoop(lambda s, b: (s._replace(step=s.step + 1),
                                   {"loss": torch.tensor(0.0)}),
                     _toy_state(), Data(), fault_hook=hook, log_every=0)
    assert not loop.resume()
    with pytest.raises(KeyboardInterrupt):
        loop.run(5)
    assert seen == [0, 1, 2]


@pytest.mark.timeout(300)
def test_sigterm_salvage_and_bitwise_resume(tmp_path):
    """``train_main`` in a subprocess gets SIGTERM mid-run: it writes a
    final checkpoint flagged ``sigterm`` at the completed step, dies with
    rc -15, and the resumed run ends bitwise equal to an uninterrupted
    one."""
    ck, steps = tmp_path / "ck", 8
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", f"--steps={steps}", "--batch=2", "--seq=16",
            "--checkpoint-every=1000", f"--checkpoint-dir={ck}"]
    proc = subprocess.Popen(argv + ["--log-every=1"],
                            env=_subproc_env(REPRO_STEP_DELAY_S="0.3"),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    seen = []
    while len(seen) < 2:
        line = proc.stdout.readline()
        assert line, "train subprocess exited before producing steps"
        if line.startswith("step "):
            seen.append(int(line.split()[1]))
    proc.send_signal(15)
    rest, _ = proc.communicate(timeout=120)
    assert proc.returncode == -15
    last = max(seen + [int(ln.split()[1]) for ln in rest.splitlines()
                       if ln.startswith("step ")])
    salvage_step, salvage = list_checkpoints(ck)[-1]
    meta = read_manifest(salvage)["metadata"]
    assert meta.get("sigterm") is True and "data_cursor" in meta
    assert salvage_step == last + 1 < steps

    res = subprocess.run(argv + ["--resume", "--log-every=0"],
                         env=_subproc_env(), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    resumed = json.loads(res.stdout)
    base = train_main("stablelm-1.6b", steps=steps,
                      checkpoint_dir=str(tmp_path / "oracle"),
                      checkpoint_async=False, **KW)
    assert resumed["resumed_from_step"] == salvage_step
    assert resumed["losses"] == base["losses"][salvage_step:]
    _assert_same_arrays(_final_arrays(ck)[0],
                        _final_arrays(tmp_path / "oracle")[0])


# ------------------------------------------------------------- interop
def test_jax_checkpoint_restores_into_the_port(tmp_path):
    ck = tmp_path / "jax"
    jax_train_main("stablelm-1.6b", steps=2, batch=2, seq=16, log_every=0,
                   checkpoint_dir=str(ck), checkpoint_async=False)
    want, wstep = jax_load(list_checkpoints(ck)[-1][1])
    cfg = get_reduced("stablelm-1.6b")
    mgr = CheckpointManager(ck)
    state, step, extra = mgr.restore_latest(
        like=init_train_state(None, cfg, device="cpu"))
    assert step == wstep == state.step == 2 and "data_cursor" in extra
    _assert_same_arrays(_flatten(state), want)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    ck = tmp_path / "port"
    train_main("stablelm-1.6b", steps=2, checkpoint_dir=str(ck),
               checkpoint_async=False, **KW)
    path = list_checkpoints(ck)[-1][1]
    want, _ = load_checkpoint(path)
    like = jax_init_state(jax.random.PRNGKey(1),
                          jax_reduced("stablelm-1.6b"))
    tree, step = jax_load(path, like=like)
    assert int(tree.step) == step == 2
    _assert_same_arrays({k: np.asarray(v) for k, v in
                         jax_flatten(tree).items()}, want)


def test_hybrid_train_main_resume_bitwise(tmp_path):
    """The reduced jamba (SSD and attention layers, MoE on every other one)
    trains through ``train_main`` (the loss includes the MoE aux term), and
    a preempted run resumes bitwise: its layers live in periods of two
    slots (``periods/slot0`` and ``periods/slot1``, optimizer moments
    too)."""
    arch = "jamba-1.5-large-398b"
    base = train_main(arch, steps=4, checkpoint_dir=str(tmp_path / "oracle"),
                      checkpoint_async=False, **KW)
    assert np.all(np.isfinite(base["losses"]))
    ck = str(tmp_path / "ck")
    with pytest.raises(Preemption):
        train_main(arch, steps=4, checkpoint_dir=ck, checkpoint_every=2,
                   preempt_at_step=3, **KW)
    res = train_main(arch, steps=4, checkpoint_dir=ck, checkpoint_every=2,
                     resume=True, **KW)
    assert res["resumed_from_step"] == 2
    assert res["losses"] == base["losses"][2:]
    _assert_same_arrays(_final_arrays(ck)[0],
                        _final_arrays(tmp_path / "oracle")[0])
    keys = read_manifest(list_checkpoints(ck)[-1][1])["keys"]
    assert {k.split("/")[2] for k in keys
            if k.startswith("params/periods/")} == {"slot0", "slot1"}


def test_hybrid_checkpoints_interoperate(tmp_path):
    """jamba's two-slot periods: the reference's checkpoint restores into
    the port, and the port's into the reference, bitwise."""
    arch = "jamba-1.5-large-398b"
    jax_train_main(arch, steps=2, batch=2, seq=16, log_every=0,
                   checkpoint_dir=str(tmp_path / "jax"),
                   checkpoint_async=False)
    want, wstep = jax_load(list_checkpoints(tmp_path / "jax")[-1][1])
    cfg = get_reduced(arch)
    P = period_len(cfg)
    state, step, _ = CheckpointManager(tmp_path / "jax",
                                       period=P).restore_latest(
        like=init_train_state(None, cfg, device="cpu"))
    assert step == wstep == 2
    _assert_same_arrays(_flatten(state, period=P), want)

    train_main(arch, steps=2, checkpoint_dir=str(tmp_path / "port"),
               checkpoint_async=False, **KW)
    path = list_checkpoints(tmp_path / "port")[-1][1]
    want, _ = load_checkpoint(path)
    tree, step = jax_load(path, like=jax_init_state(
        jax.random.PRNGKey(1), jax_reduced(arch)))
    assert int(tree.step) == step == 2
    _assert_same_arrays({k: np.asarray(v) for k, v in
                         jax_flatten(tree).items()}, want)


_NO_ML_DTYPES = textwrap.dedent('''
    import sys
    sys.modules["ml_dtypes"] = None          # importing it now fails
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.checkpoint import (load_checkpoint, read_manifest,
                                        save_checkpoint)
    from repro_torch.configs import get_reduced
    from repro_torch.convert import params_to_flat
    from repro_torch.models import init_params
    from repro_torch.train import init_train_state
    from repro_torch.tree import tree_leaves

    ref_dir, out_dir = sys.argv[1], sys.argv[2]
    cfg = dataclasses.replace(get_reduced("stablelm-1.6b"),
                              param_dtype="bfloat16")
    # the reference's bf16 checkpoint, restored bitwise
    like = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    params, _ = load_checkpoint(ref_dir, like=like)
    want = np.load(ref_dir + "/bits.npz")
    for key, arr in params_to_flat(params).items():
        assert arr.dtype == np.dtype("V2"), key
        assert np.array_equal(arr.view(np.uint16), want[key.replace("/", "|")])
    # the port's own bf16 TrainState, written and read back bitwise
    state = init_train_state(torch.Generator().manual_seed(2), cfg,
                             device="cpu")
    save_checkpoint(out_dir, state, step=0)
    keys = read_manifest(out_dir)["keys"]
    assert keys["params/embed/w"]["dtype"] == "bfloat16"
    back, _ = load_checkpoint(out_dir, like=init_train_state(
        torch.Generator().manual_seed(3), cfg, device="cpu"))
    for a, b in zip(tree_leaves(state.params), tree_leaves(back.params)):
        assert b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert sys.modules["ml_dtypes"] is None
    print("ok")
''')


def test_bf16_round_trips_without_ml_dtypes(tmp_path):
    import dataclasses
    jcfg = dataclasses.replace(jax_reduced("stablelm-1.6b"),
                               param_dtype="bfloat16")
    jparams = JM.init_params(jax.random.PRNGKey(4), jcfg)
    ref_dir = tmp_path / "ref"
    jax_save(ref_dir, jparams)
    np.savez(ref_dir / "bits.npz",
             **{k.replace("/", "|"): np.asarray(v).view(np.uint16)
                for k, v in jax_flatten(jparams).items()})
    res = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES, str(ref_dir),
                          str(tmp_path / "port")], env=_subproc_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
