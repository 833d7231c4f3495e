"""One tp row across two processes: two gloo ranks on the CPU, each holding
one device of a dp 1 x tp 2 mesh from ``make_global_mesh(tp=2)``, against
the port in one process.

The reference lays ``(dp, tp)`` over every process's devices
(``mimic3_tpu/parallel/distributed.py::make_global_mesh``) and places the
params across processes.  The port gives each rank one device, so its tp
rows span ranks: each rank runs the row's program on its device with its
own part of each split leaf, and ``parallel/tensor.py``'s collectives run
over the row's process group.

The pair of ranks (this file run as ``python
tests/test_torch_port_tp_distributed.py PORT RANK WORKDIR``; it imports
the port only) checks:

- the mesh: its shape and processes, this rank's row and column, the two
  groups, and the ``ValueError`` of a tp that does not divide the ranks;
- serving: a ``use_tp`` session over the mesh gives both ranks every row
  within ``atol=2e-5`` of the one-device session, with equal durations,
  and one reduction per FFN and one gather per upsampler per call;
- training (learning rate 0, draws from a generator seeded 123): one step
  against the one-process port step on the same batch (losses within
  ``rtol=1e-5``, every gradient, parts gathered, within relative L2
  1e-5, the same set of zero gradients), on both ranks;
- the same step with its gradient sum taken over the world instead of
  the dp group (here the sum over one rank): the gradient check fails,
  since the replicated gradients double and the ranks' different parts of
  a split leaf add;
- a step with the config's learning rate: every replicated parameter
  bitwise equal on both ranks.
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

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 150  # seconds, the pair of ranks
SEQS = [[1, 5, 9, 2, 7, 3], [4, 4, 8, 1], [2, 9, 9, 9, 5], [7, 1]]
DET = dict(noise_scale=0.0, noise_w=0.0, seed=3)
BUCKETS = dict(text_buckets=(16,), frame_buckets=(64,), batch_buckets=(4,),
               speculative_decode=False)
BATCH_FIELDS = ("phoneme_ids", "text_lengths", "audio", "spec_lengths")
METRICS = ("loss_g", "loss_mel", "loss_kl", "loss_dur", "loss_adv",
           "loss_fm", "loss_d")


# ---------------------------------------------------------------------------
# one rank (run as a script)
# ---------------------------------------------------------------------------


def _unflat(named):
    tree = {}
    for name, value in named.items():
        node = tree
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


def _session_config(voice):
    from mimic3_tpu_torch.config import TrainingConfig

    config = TrainingConfig.load_path(voice / "config.json")
    for key, value in BUCKETS.items():
        setattr(config.tpu, key, value)
    return config


def _durations(session):
    """Replica 0's durations for ``SEQS`` as the session pads them (every
    rank of the row calls this: the encoder's FFNs reduce over it)."""
    ids, lengths, sid = session._pad(SEQS, None, "duration")
    rep = session._replicas[0]
    durations, _ = session.model.infer_durations(
        rep.params, session._put(ids, rep.device),
        session._put(lengths, rep.device), 0, 1.0, 0.0,
        sid=session._sid(sid, rep.device),
    )
    return durations.numpy()


def worker(port: int, rank: int, work: Path) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from mimic3_tpu_torch.config import TrainingConfig
    from mimic3_tpu_torch.models.vits import train as T
    from mimic3_tpu_torch.parallel import (
        Split,
        all_reduce_sum,
        gather_params,
        initialize_distributed,
        make_global_mesh,
        process_local_batch_slice,
    )
    from mimic3_tpu_torch.parallel import tensor as tpt
    from mimic3_tpu_torch.runtime.convert import (
        load_pytree_npz,
        to_torch_train_params,
    )
    from mimic3_tpu_torch.runtime.session import TorchVitsSession

    assert initialize_distributed(f"127.0.0.1:{port}", 2, rank,
                                  device="cpu") is True
    out = {}
    try:
        make_global_mesh(tp=3, device="cpu")
    except ValueError as err:
        out["tp3"] = str(err)
    mesh = make_global_mesh(tp=2, device="cpu")
    out.update(
        shape=mesh.shape, processes=mesh.processes.tolist(),
        rows=[[r.index, [str(d) for d in r.devices], r.column]
              for r in mesh.local_rows()],
        groups=[dist.get_world_size(mesh.tp_group),
                dist.get_world_size(mesh.dp_group)],
        slice=list(process_local_batch_slice(4, mesh)),
    )

    # serving
    voice = work / "voice"
    session = TorchVitsSession(
        _session_config(voice), load_pytree_npz(voice / "generator.npz"),
        deterministic=True, mesh=mesh, use_tp=True,
    )
    tpt.gathers = tpt.reductions = 0
    audio = session.synthesize_ids_batch(SEQS, **DET)
    out["collectives"] = [tpt.reductions, tpt.gathers]
    np.savez(work / f"infer_{rank}.npz", *audio,
             durations=_durations(session))

    # training
    cfg = TrainingConfig.from_dict(
        json.loads((work / "train.json").read_text()))
    arrays = dict(np.load(work / "train_in.npz"))
    batch = T.TrainBatch(*(torch.from_numpy(arrays[k])
                           for k in BATCH_FIELDS))

    def tree(prefix):
        return to_torch_train_params(_unflat({
            k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)
        }))

    def grads(state):
        """Every gradient, a split leaf's gathered over the row."""
        named = {}
        for key, params in (("g", state.params), ("d", state.disc_params)):
            as_grads = {
                name: Split(tuple(p.grad for p in leaf.parts), leaf.axis,
                            leaf.row)
                if isinstance(leaf, Split) else leaf.grad
                for name, leaf in _flat(params).items()
            }
            for name, g in _flat(gather_params(_unflat(as_grads))).items():
                named[f"{key}.{name}"] = g.numpy()
        return named

    def step(lr, seed):
        cfg.learning_rate = lr
        state = T.init_train_state(tree("g."), tree("d."), cfg, mesh=mesh,
                                   use_tp=True)
        state, metrics = T.make_train_step(cfg)(
            state, batch, generator=torch.Generator().manual_seed(seed))
        return state, {k: float(v) for k, v in metrics.items()}

    saved = {}
    state, out["metrics"] = step(0.0, 123)
    saved.update({f"a.{k}": v for k, v in grads(state).items()})
    # the deliberate fault: the gradient sum over the world, not the dp
    # group
    right = T._Parallel.sum
    T._Parallel.sum = lambda self, tensors: all_reduce_sum(tensors)
    try:
        state, _ = step(0.0, 123)
    finally:
        T._Parallel.sum = right
    saved.update({f"b.{k}": v for k, v in grads(state).items()})
    state, _ = step(1e-3, 7)
    for key, leaves in (("g", state.g_leaves), ("d", state.d_leaves)):
        for name, t in leaves:
            saved[f"c.{key}.{name}"] = t.detach().numpy()
    np.savez(work / f"train_{rank}.npz", **saved)
    (work / f"out_{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    print(f"rank {rank} ok", flush=True)


# ---------------------------------------------------------------------------
# the test process
# ---------------------------------------------------------------------------


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


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import torch_train_reference as ref_lib
    from mimic3_tpu_torch.models.vits import train as ttrain
    from mimic3_tpu_torch.runtime.convert import load_pytree_npz
    from mimic3_tpu_torch.runtime.session import TorchVitsSession
    from mimic3_tpu_torch.runtime.testvoice import create_test_voice

    work = tmp_path_factory.mktemp("tp_dist")
    create_test_voice(work / "voice", full_size=False)
    tcfg = ref_lib.config(port=True, learning_rate=0.0)
    state0 = ref_lib.port_initial_state(tcfg)
    b = ref_lib.batch_arrays(rows=4)
    np.savez(work / "train_in.npz", **b, **{
        f"g.{k}": v for k, v in ref_lib.flat(state0.params).items()
    }, **{f"d.{k}": v for k, v in ref_lib.flat(state0.disc_params).items()})
    (work / "train.json").write_text(json.dumps(
        ref_lib.config(port=True).to_dict()))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(port), str(rank), str(work)],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
    ) for rank in (0, 1)]
    try:
        # the one-process references, while the ranks run
        voice = work / "voice"
        single = TorchVitsSession(
            _session_config(voice), load_pytree_npz(voice / "generator.npz"),
            deterministic=True, device="cpu",
        )
        want_audio = single.synthesize_ids_batch(SEQS, **DET)
        want_durations = _durations(single)
        state = ttrain.init_train_state(
            ref_lib.carry(state0.params), ref_lib.carry(state0.disc_params),
            tcfg)
        state, metrics = ttrain.make_train_step(tcfg)(
            state, ref_lib.t_batch(b),
            generator=torch.Generator().manual_seed(123))
        one = ({k: float(v) for k, v in metrics.items()},
               {f"{k}.{n}": t.grad.numpy()
                for k, leaves in (("g", state.g_leaves),
                                  ("d", state.d_leaves))
                for n, t in leaves})
    finally:
        results = []
        for proc in procs:
            try:
                text, _ = proc.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                text, _ = proc.communicate()
            results.append((proc.returncode, text))
    for rank, (rc, text) in enumerate(results):
        assert rc == 0 and f"rank {rank} ok" in text, text[-3000:]
    return dict(
        work=work, ref_lib=ref_lib, audio=want_audio,
        initial=ttrain.tree_leaves(ref_lib.carry(state0.params)),
        durations=want_durations, one=one,
        out=[json.loads((work / f"out_{r}.json").read_text())
             for r in (0, 1)],
        infer=[np.load(work / f"infer_{r}.npz") for r in (0, 1)],
        train=[np.load(work / f"train_{r}.npz") for r in (0, 1)],
    )


def _tagged(npz, tag):
    prefix = f"{tag}."
    return {k[len(prefix):]: npz[k] for k in npz.files
            if k.startswith(prefix)}


def _check(ref_lib, want, got):
    """{tree: the gradients past relative L2 1e-5}, each tree on its own
    (``gradient_errors`` names the zero-gradient leaves without a tree
    prefix)."""
    bad = {}
    for tree in ("g", "d"):
        strip = {k[2:]: v for k, v in want.items() if k[0] == tree}
        bad[tree] = ref_lib.gradient_errors(
            strip, {k[2:]: v for k, v in got.items() if k[0] == tree}, 1e-5)
    return bad


def test_global_mesh_spans_the_ranks(run):
    for rank, out in enumerate(run["out"]):
        # the reference's layout: dp = devices // tp, rows contiguous in
        # process order
        assert out["shape"] == {"dp": 1, "tp": 2}
        assert out["processes"] == [[0, 1]]
        assert out["rows"] == [[0, ["cpu"], rank]]
        assert out["groups"] == [2, 1]
        # both ranks of the row hold the same rows of a batch
        assert out["slice"] == [0, 4]
        assert "tp=3 does not divide the 2 processes" in out["tp3"]


def test_serving_across_the_row_equals_one_device(run):
    for rank, got in enumerate(run["infer"]):
        audio = [got[f"arr_{i}"] for i in range(len(SEQS))]
        for g, w in zip(audio, run["audio"]):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=0)
        np.testing.assert_array_equal(got["durations"], run["durations"])
        # the tiny voice's 2 FFNs in the duration and the decode pass,
        # and its 4 upsamplers, each one collective
        assert run["out"][rank]["collectives"] == [4, 4]


def test_step_across_the_row_equals_the_one_process_step(run):
    want_metrics, want = run["one"]
    for rank in (0, 1):
        got_metrics = run["out"][rank]["metrics"]
        for name in METRICS:
            np.testing.assert_allclose(got_metrics[name], want_metrics[name],
                                       rtol=1e-5, err_msg=name)
        bad = _check(run["ref_lib"], want, _tagged(run["train"][rank], "a"))
        assert bad == {"g": {}, "d": {}}, (rank, bad)


def test_a_sum_over_the_world_is_caught(run):
    _, want = run["one"]
    got = _tagged(run["train"][0], "b")
    bad = _check(run["ref_lib"], want, got)
    # every replicated gradient doubles ...
    assert "enc_p.emb.weight" in bad["g"] and bad["d"]
    # ... and a split leaf's parts add: each part is the sum of both
    assert "dec.ups.0.weight_v" in bad["g"]
    assert "enc_p.ffn_layers.0.conv_1.weight" in bad["g"]


def test_replicated_parameters_bitwise_equal_across_the_row(run):
    ranks = [_tagged(npz, "c") for npz in run["train"]]
    shared = set(ranks[0]) & set(ranks[1])
    parts = set(ranks[0]) ^ set(ranks[1])
    assert parts and all(name.endswith("]") for name in parts)
    assert {n for n in ranks[0] if n.endswith("]")} == {
        n.replace("[1]", "[0]") for n in ranks[1] if n.endswith("]")}
    for name in shared:
        np.testing.assert_array_equal(ranks[0][name], ranks[1][name],
                                      err_msg=name)
    initial = {f"g.{n}": t.numpy() for n, t in run["initial"]}
    moved = [n for n in shared if n in initial
             and not np.array_equal(ranks[0][n], initial[n])]
    # the step moved them (about half of the generator's tensors get a
    # gradient from this batch, as on one device)
    assert {"g.dec.conv_post.weight", "g.enc_p.emb.weight"} <= set(moved)
    assert len(moved) > len(initial) // 3


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
