"""One rank of ``tests/test_torch_port_distributed.py``'s two-process run
on the CPU (gloo), importing the port only.

    python tests/torch_dp_worker.py PORT RANK WORKDIR

Coordinates through ``initialize_distributed`` at ``127.0.0.1:PORT``,
then in ``WORKDIR``: a global sum and gather (``coord_RANK.json``); a dp2
session over ``make_global_mesh`` synthesizing ``SEQS``
(``infer_RANK.npz``); and three data-parallel train steps on this rank's
rows of ``train_in.npz`` with the config of ``train.json``
(``train_RANK.npz``):

- ``a``: learning rate 0, draws from a generator seeded 123;
- ``b``: learning rate 0, the global batch's draws injected;
- ``c``: the config's learning rate, from the state ``a`` left, whose
  parameters are saved.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

SEQS = [[1, 5, 9, 2, 7, 3], [4, 4, 8, 1], [2, 9, 9, 9, 5], [7, 1]]
INFER = dict(noise_scale=0.667, noise_w=0.8, seed=3)
BUCKETS = dict(text_buckets=(16,), frame_buckets=(64,), batch_buckets=(4,))
BATCH_FIELDS = ("phoneme_ids", "text_lengths", "audio", "spec_lengths",
                "speaker_ids")


def unflat(named):
    tree = {}
    for name, value in named.items():
        node = tree
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def leaves(state):
    """(name, tensor) of every parameter, ``g.``/``d.`` for the trees."""
    return [(f"g.{n}", t) for n, t in state.g_leaves] + [
        (f"d.{n}", t) for n, t in state.d_leaves
    ]


def main(port: int, rank: int, work: Path) -> None:
    torch.set_num_threads(1)
    from mimic3_tpu_torch.config import TrainingConfig
    from mimic3_tpu_torch.models.vits import train as T
    from mimic3_tpu_torch.parallel import (
        all_gather_rows,
        all_reduce_sum,
        initialize_distributed,
        make_global_mesh,
        process_local_batch_slice,
    )
    from mimic3_tpu_torch.runtime.convert import (
        load_pytree_npz,
        to_torch_train_params,
    )
    from mimic3_tpu_torch.runtime.session import TorchVitsSession

    assert initialize_distributed(f"127.0.0.1:{port}", 2, rank,
                                  device="cpu") is True
    assert torch.distributed.get_backend() == "gloo"
    assert initialize_distributed(device="cpu") is True  # idempotent
    mesh = make_global_mesh(device="cpu")
    assert mesh.shape == {"dp": 2, "tp": 1}
    assert mesh.process_index == rank and mesh.multiprocess
    start, size = process_local_batch_slice(8)
    local = torch.arange(start, start + size, dtype=torch.float32)
    (work / f"coord_{rank}.json").write_text(json.dumps({
        "slice": [start, size],
        "total": float(all_reduce_sum([local])[0].sum()),
        "gathered": all_gather_rows(local).tolist(),
    }))

    voice = work / "voice"
    tc = TrainingConfig.load_path(voice / "config.json")
    for key, value in BUCKETS.items():
        setattr(tc.tpu, key, value)
    tc.tpu.speculative_decode = False
    session = TorchVitsSession(
        tc, load_pytree_npz(voice / "generator.npz"), deterministic=True,
        mesh=mesh,
    )
    audio = session.synthesize_ids_batch(SEQS, **INFER)
    np.savez(work / f"infer_{rank}.npz", *audio)

    cfg = TrainingConfig.from_dict(
        json.loads((work / "train.json").read_text())
    )
    arrays = dict(np.load(work / "train_in.npz"))
    shard = T.Shard(rank, 2)
    rows = shard.rows(arrays["phoneme_ids"].shape[0])
    batch = T.TrainBatch(*(
        torch.from_numpy(arrays[k][rows]) for k in BATCH_FIELDS
    ))
    noise = T.TrainNoise(*(
        torch.from_numpy(arrays[f"noise.{k}"])
        for k in ("posterior", "duration", "starts")
    ))

    def tree(prefix):
        return to_torch_train_params(unflat({
            k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)
        }))

    out = {}

    def keep(tag, state, metrics):
        for k, v in metrics.items():
            out[f"{tag}.metric.{k}"] = v.numpy()
        for name, t in leaves(state):
            out[f"{tag}.grad.{name}"] = t.grad.numpy().copy()

    lr = cfg.learning_rate
    cfg.learning_rate = 0.0
    step = T.make_train_step(cfg)
    state = T.init_train_state(tree("g."), tree("d."), cfg)
    gen = torch.Generator().manual_seed(123)
    state, metrics = step(state, batch, generator=gen, shard=shard)
    keep("a", state, metrics)
    other = T.init_train_state(tree("g."), tree("d."), cfg)
    other, metrics = step(other, batch, noise=noise, shard=shard)
    keep("b", other, metrics)
    cfg.learning_rate = lr
    step = T.make_train_step(cfg)
    state, _ = step(state, batch, generator=gen.manual_seed(7), shard=shard)
    for name, t in leaves(state):
        out[f"c.param.{name}"] = t.detach().numpy()
    np.savez(work / f"train_{rank}.npz", **out)
    torch.distributed.destroy_process_group()
    print(f"rank {rank} ok", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
