"""``torch.distributed`` on the port: two real processes on the CPU (gloo)
coordinating over localhost, as ``tests/test_distributed.py`` runs two
``jax.distributed`` processes.

One pair of processes (``tests/torch_dp_worker.py``) checks, in order:

- coordination: ``initialize_distributed`` (idempotent), the global mesh,
  ``process_local_batch_slice``, a global sum and a gather;
- dp2 inference: a session over ``make_global_mesh()`` gives every rank
  every row, equal to the single-device session within ``atol=2e-5``;
- one dp2 train step on the multi-speaker tiny config (speaker ids are
  sharded too), each rank on its half of a global batch of 4: against the
  single-process port step on the same global batch and generator
  (losses within ``rtol=1e-5``, every summed gradient within relative L2
  1e-5); against the reference's ``make_train_step`` with the reference's
  draws injected (``test_torch_port_train_step.py``'s bars); and the
  parameters bit-equal across the ranks after a step with a learning
  rate.

Beside it, ``mimic3-torch-train`` under ``python -m torch.distributed.run
--nproc_per_node 2``: batch 3 rounds to 4, and only rank 0 writes the
checkpoint and the export.  Both launches run while this process computes
the single-device and JAX references; each has a timeout of its own.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch._dynamo  # noqa: F401  (see tests/torch_train_reference.py)

import jax

import torch_train_reference as ref_lib
from test_torch_port_train_cli import make_dataset
from mimic3_tpu_torch.models.vits import train as ttrain
from mimic3_tpu_torch.runtime.convert import load_pytree_npz, to_jax_layout
from mimic3_tpu_torch.runtime.session import TorchVitsSession
from mimic3_tpu_torch.runtime.testvoice import create_test_voice
from mimic3_tpu_torch.config import TrainingConfig as TTrainingConfig

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 120  # seconds, each launch
MULTISPEAKER = dict(n_speakers=4, gin_channels=16)
METRICS = ("loss_g", "loss_mel", "loss_kl", "loss_dur", "loss_adv",
           "loss_fm", "loss_d")
SEQS = [[1, 5, 9, 2, 7, 3], [4, 4, 8, 1], [2, 9, 9, 9, 5], [7, 1]]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _env():
    env = dict(os.environ)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MIMIC3_DP"):
        env.pop(var, None)
    env.update(
        OMP_NUM_THREADS="1",
        PYTHONPATH=os.pathsep.join(
            [str(REPO)] + env.get("PYTHONPATH", "").split(os.pathsep)
        ),
    )
    return env


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _popen(argv):
    return subprocess.Popen(
        [sys.executable, *map(str, argv)], env=_env(), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def _wait(proc):
    try:
        out, _ = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise AssertionError(f"timed out after {TIMEOUT}s:\n{out[-3000:]}")
    return proc.returncode, out


def _single_step(tcfg, params0, disc0, b, **kwargs):
    """The one-process port step on the global batch: metrics and the
    gradients by dotted name (torch layout)."""
    state = ttrain.init_train_state(ref_lib.carry(params0),
                                    ref_lib.carry(disc0), tcfg)
    state, metrics = ttrain.make_train_step(tcfg)(
        state, ref_lib.t_batch(b), **kwargs
    )
    return ({k: float(v) for k, v in metrics.items()},
            {**{f"g.{n}": t.grad.numpy() for n, t in state.g_leaves},
             **{f"d.{n}": t.grad.numpy() for n, t in state.d_leaves}})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("dist")
    # inputs of the worker pair
    create_test_voice(work / "voice", full_size=False)
    tcfg = ref_lib.config(port=True, model=MULTISPEAKER, learning_rate=0.0)
    state0 = ref_lib.port_initial_state(tcfg)
    params0, disc0 = state0.params, state0.disc_params
    b = ref_lib.batch_arrays(rows=4, n_speakers=4)
    rng = jax.random.PRNGKey(1)
    noise = ref_lib.reference_noise(rng, b, tcfg)
    np.savez(work / "train_in.npz", **b, **{
        f"g.{k}": v for k, v in ref_lib.flat(params0).items()
    }, **{f"d.{k}": v for k, v in ref_lib.flat(disc0).items()}, **{
        f"noise.{k}": getattr(noise, k).numpy()
        for k in ("posterior", "duration", "starts")
    })
    (work / "train.json").write_text(json.dumps(
        ref_lib.config(port=True, model=MULTISPEAKER).to_dict()
    ))
    port = _free_port()
    workers = [_popen([REPO / "tests" / "torch_dp_worker.py", port, rank,
                       work]) for rank in (0, 1)]
    # mimic3-torch-train under the launcher, alongside
    voice_dir, audio_dir, metadata = make_dataset(work / "cli")
    ckpt = work / "cli" / "ckpt"
    trainer = _popen([
        "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
        "2", "--redirects", "3", "--log-dir", work / "cli" / "logs", "-m",
        "mimic3_tpu_torch.train_cli", voice_dir, "--metadata", metadata,
        "--audio-dir", audio_dir, "--batch-size", "3", "--steps", "1",
        "--checkpoint-dir", ckpt, "--log-every", "1", "--device", "cpu",
        "--export",
    ])
    try:
        # the references, while the launches run
        tc = TTrainingConfig.load_path(work / "voice" / "config.json")
        tc.tpu.text_buckets, tc.tpu.frame_buckets = (16,), (64,)
        tc.tpu.batch_buckets, tc.tpu.speculative_decode = (4,), False
        single = TorchVitsSession(
            tc, load_pytree_npz(work / "voice" / "generator.npz"),
            deterministic=True, device="cpu",
        ).synthesize_ids_batch(SEQS, noise_scale=0.667, noise_w=0.8, seed=3)
        one = _single_step(tcfg, params0, disc0, b,
                           generator=torch.Generator().manual_seed(123))
        reference = ref_lib.reference_step(
            ref_lib.config(model=MULTISPEAKER), state0, b, rng
        )
    finally:
        results = [_wait(p) for p in workers]
        trainer_result = _wait(trainer)
    return dict(work=work, workers=results, trainer=trainer_result,
                single=single, one=one, reference=reference,
                params0=params0, disc0=disc0,
                ckpt=ckpt, voice_dir=voice_dir)


def _rank_outputs(run, name):
    for rank, (rc, out) in enumerate(run["workers"]):
        assert rc == 0 and f"rank {rank} ok" in out, out[-3000:]
    return [run["work"] / name.format(rank=r) for r in (0, 1)]


def test_two_process_coordination(run):
    for rank, path in enumerate(_rank_outputs(run, "coord_{rank}.json")):
        got = json.loads(path.read_text())
        assert got["slice"] == [4 * rank, 4]
        assert got["total"] == sum(range(8))
        assert got["gathered"] == list(range(8))


def test_dp2_inference_every_rank_gets_every_row(run):
    for path in _rank_outputs(run, "infer_{rank}.npz"):
        got = np.load(path)
        got = [got[f"arr_{i}"] for i in range(len(got.files))]
        assert len(got) == len(run["single"])
        for g, w in zip(got, run["single"]):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=0)


def _train(run):
    return [np.load(p) for p in _rank_outputs(run, "train_{rank}.npz")]


def _tagged(npz, tag, kind):
    prefix = f"{tag}.{kind}."
    return {k[len(prefix):]: npz[k] for k in npz.files
            if k.startswith(prefix)}


def test_dp2_step_equals_the_single_process_step(run):
    """The same global batch and generator: the data-parallel step's
    losses and summed gradients are the one-process step's, on both
    ranks."""
    want_metrics, want_grads = run["one"]
    for npz in _train(run):
        metrics = _tagged(npz, "a", "metric")
        for name in METRICS:
            np.testing.assert_allclose(float(metrics[name]),
                                       want_metrics[name], rtol=1e-5,
                                       err_msg=name)
        got = _tagged(npz, "a", "grad")
        assert got["g.emb_g.weight"].any()  # the speaker table trains
        bad = ref_lib.gradient_errors(want_grads, got, 1e-5)
        assert not bad, bad


def test_dp2_step_matches_the_reference(run):
    """With the reference's draws of the global batch injected, each rank's
    step is held to the reference's one-device step at
    test_torch_port_train_step.py's bars."""
    metrics, grads_g, grads_d = run["reference"]
    for npz in _train(run):
        got_metrics = _tagged(npz, "b", "metric")
        for name in METRICS:
            np.testing.assert_allclose(float(got_metrics[name]),
                                       float(metrics[name]), rtol=1e-3,
                                       err_msg=name)
        # each tree in the reference's layout
        got = ref_lib.flat(to_jax_layout(ref_lib.unflat({
            n: torch.from_numpy(g) for n, g in _tagged(npz, "b", "grad").items()
        })))
        for tree, want in (("g", grads_g), ("d", grads_d)):
            bad = ref_lib.gradient_errors(
                ref_lib.flat(want),
                {k[2:]: v for k, v in got.items() if k[0] == tree}, 1e-3,
            )
            assert not bad, (tree, bad)


def test_dp2_params_bit_equal_across_ranks(run):
    rank0, rank1 = (_tagged(npz, "c", "param") for npz in _train(run))
    assert set(rank0) == set(rank1)
    for name in rank0:
        np.testing.assert_array_equal(rank0[name], rank1[name], err_msg=name)
    # the step moved them
    initial = {
        f"{tree}.{n}": t.numpy()
        for tree, params in (("g", run["params0"]), ("d", run["disc0"]))
        for n, t in ttrain.tree_leaves(ref_lib.carry(params))
    }
    assert set(rank0) == set(initial)
    moved = [n for n in rank0 if not np.array_equal(rank0[n], initial[n])]
    assert len(moved) > len(rank0) // 2


def test_train_cli_under_two_ranks(run):
    rc, out = run["trainer"]
    assert rc == 0, out[-3000:]
    logs = sorted((run["work"] / "cli" / "logs").rglob("stderr.log"))
    by_rank = {p.parent.name: p.read_text() for p in logs}
    assert set(by_rank) == {"0", "1"}, logs
    for text in by_rank.values():
        assert "Rounded batch size to 4 (world size 2)" in text
        assert "backend gloo" in text
        assert "step 1 " in text
    assert "Final checkpoint" in by_rank["0"]
    assert "Exported" in by_rank["0"]
    assert "Final checkpoint" not in by_rank["1"]
    assert "Exported" not in by_rank["1"]
    assert (run["ckpt"] / "1" / "state.pt").is_file()
    assert (run["voice_dir"] / "generator.npz").is_file()
    digests = {r: text.split("Final parameter digest")[1].split(": ")[1]
               .split()[0] for r, text in by_rank.items()}
    assert digests["0"] == digests["1"]
    # both ranks logged the same global losses
    steps = [next(ln for ln in by_rank[r].splitlines() if "step 1 " in ln)
             for r in ("0", "1")]
    assert steps[0].split("step 1 ")[1].split(" (")[0] == \
        steps[1].split("step 1 ")[1].split(" (")[0]
