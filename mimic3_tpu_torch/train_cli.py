"""``mimic3-torch-train``: train or fine-tune a VITS voice with PyTorch.

Port copy of ``mimic3_tpu/train_cli.py`` (``mimic3-train``).  A voice
directory provides ``config.json`` + ``phonemes.txt`` (and optionally
``generator.npz`` to fine-tune); data is LJSpeech-style ``metadata.csv``
+ WAVs.

Runs on the card unless ``--device cpu`` is given, and without a card it
raises as the port's other entry points do.  Data parallel over N cards
with one process per card, launched by PyTorch's launcher::

    python -m torch.distributed.run --nproc_per_node N \
        -m mimic3_tpu_torch.train_cli VOICE_DIR --metadata ... ...

Each rank trains on ``cuda:LOCAL_RANK`` (``parallel/distributed.py``
picks the backend) as one dp row of ``parallel.make_global_mesh()``,
iterates the same seeded batch stream and keeps its rows of each global
batch (rounded up to a multiple of the world size); the step sums the
gradients over the mesh's dp group (``models/vits/train.py``), so it
equals the one-device step on the global batch.  Checkpoints are
``torch.save`` files under ``--checkpoint-dir/<step>/``; ``--export``
writes inference weights back to the voice directory as the reference's
``generator.npz`` (JAX layout, weight norm folded, no ``enc_q``), which
the port's engine and the JAX package both load.  Rank 0 alone writes
both; the other ranks wait for it.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
import typing
from pathlib import Path

import numpy as np

_LOGGER = logging.getLogger(__name__)

CHECKPOINT_FILE = "state.pt"


def merge_pretrained(init_params, pretrained):
    """Overlay inference weights onto freshly-initialized training params,
    PRESERVING the training tree's structure (both in the JAX layout).

    generator.npz stores folded conv weights (``weight``), while training
    params are weight-normed (``weight_v``/``weight_g``).  Where the init
    tree uses weight norm and the pretrained dict has a folded ``weight``
    W, re-expand it as ``v = W, g = ||W||`` (norm over all axes but the
    output channel, the last of ``[K, Cin, Cout]``) so ``g * v / ||v|| ==
    W`` exactly.
    """
    if not isinstance(init_params, dict) or not isinstance(pretrained, dict):
        return pretrained  # leaf (or structure novelty): take pretrained
    out = dict(init_params)
    if "weight_v" in init_params and "weight" in pretrained:
        w = np.asarray(pretrained["weight"], np.float32)
        out["weight_v"] = w
        out["weight_g"] = np.sqrt(
            np.sum(np.square(w), axis=(0, 1), keepdims=True)
        )
        pretrained = {k: v for k, v in pretrained.items() if k != "weight"}
    for key, value in pretrained.items():
        out[key] = (
            merge_pretrained(init_params[key], value)
            if key in init_params
            else value
        )
    return out


def export_params(params) -> typing.Dict[str, typing.Any]:
    """Inference weights of a torch-layout training tree: the reference's
    ``generator.npz`` pytree (JAX layout, weight norm folded, without the
    training-only posterior encoder).  Leaves split over a tp row are
    gathered first (``parallel.gather_params``: over a row that spans
    processes, every rank of the row calls this)."""
    from .parallel import gather_params
    from .runtime.convert import fold_weight_norm, to_jax_layout

    def fold_tree(p):
        if "weight_v" in p:
            out = {k: v for k, v in p.items()
                   if k not in ("weight_v", "weight_g")}
            out["weight"] = fold_weight_norm(p["weight_g"], p["weight_v"])
            return out
        return {k: fold_tree(v) if isinstance(v, dict) else v
                for k, v in p.items()}

    return fold_tree(to_jax_layout(gather_params(
        {k: v for k, v in params.items() if k != "enc_q"}
    )))


def params_digest(state) -> str:
    """SHA-256 of every generator and discriminator parameter's bytes, in
    the trees' order."""
    import hashlib

    digest = hashlib.sha256()
    for _, t in state.g_leaves + state.d_leaves:
        digest.update(t.detach().cpu().contiguous().numpy().tobytes())
    return digest.hexdigest()


def save_checkpoint(path: Path, state) -> None:
    import torch

    path.mkdir(parents=True, exist_ok=True)
    torch.save(
        {
            "params": state.params,
            "disc_params": state.disc_params,
            "opt_g": state.opt_g.state_dict(),
            "opt_d": state.opt_d.state_dict(),
            "step": state.step,
        },
        path / CHECKPOINT_FILE,
    )


def load_checkpoint(path: Path, config, device, mesh=None):
    """The :class:`~.models.vits.train.TrainState` saved at ``path`` (on
    ``mesh`` when given)."""
    import torch

    from .models.vits.train import init_train_state

    saved = torch.load(
        path / CHECKPOINT_FILE, map_location=device, weights_only=True
    )
    state = init_train_state(saved["params"], saved["disc_params"], config,
                             mesh=mesh)
    state.opt_g.load_state_dict(saved["opt_g"])
    state.opt_d.load_state_dict(saved["opt_d"])
    state.step = int(saved["step"])
    return state


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="mimic3-torch-train",
        description="Train/fine-tune a VITS voice with PyTorch",
    )
    parser.add_argument(
        "voice_dir",
        help="Voice directory with config.json + phonemes.txt "
        "(+ generator.npz to fine-tune)",
    )
    parser.add_argument("--metadata", required=True,
                        help="metadata.csv (id|text per row)")
    parser.add_argument("--audio-dir", required=True,
                        help="Directory of <id>.wav files")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="Global batch (default: config batch_size)")
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--checkpoint-every", type=int, default=500)
    parser.add_argument("--resume", action="store_true",
                        help="Resume from the latest checkpoint")
    parser.add_argument("--learning-rate", type=float, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--export", action="store_true",
                        help="Write generator.npz after training")
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument(
        "--device", default=None,
        help="Device to train on (default: cuda; 'cpu' to train on the CPU)",
    )
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.debug else logging.INFO
    )

    import torch

    from .config import TrainingConfig
    from .models.vits.model import mix_seed
    from .models.vits.train import (
        TrainBatch,
        init_train_state,
        init_training_params,
        make_train_step,
    )
    from .parallel import (
        initialize_distributed,
        make_global_mesh,
        process_local_batch_slice,
    )
    from .parallel.distributed import local_device
    from .runtime.convert import (
        load_pytree_npz,
        save_pytree_npz,
        to_torch_train_params,
    )
    from .runtime.dataset import batches, load_metadata, make_frontend
    from .runtime.session import resolve_device

    # several processes (torch.distributed.run's variables set): join
    # the group first; one process: a no-op
    multi_process = initialize_distributed(device=args.device)
    mesh = None
    if multi_process:
        import torch.distributed as dist

        device = local_device(args.device)
        # one dp row per rank; the step sums over the mesh's dp group
        mesh = make_global_mesh(device=args.device)
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        device = resolve_device(args.device)
        rank, world = 0, 1
    leader = rank == 0
    voice_dir = Path(args.voice_dir)
    config = TrainingConfig.load_path(voice_dir / "config.json")
    if args.learning_rate:
        config.learning_rate = args.learning_rate
    if args.seed is not None:
        config.seed = args.seed
    batch_size = args.batch_size or config.batch_size
    if batch_size % world:
        batch_size += world - batch_size % world
        _LOGGER.info("Rounded batch size to %d (world size %d)",
                     batch_size, world)

    _LOGGER.info("Phonemizing dataset...")
    frontend = make_frontend(voice_dir)
    utterances = load_metadata(
        args.metadata,
        args.audio_dir,
        frontend,
        multispeaker=config.model.is_multispeaker,
    )
    if not utterances:
        _LOGGER.error("No usable utterances")
        return 1

    params, disc_params = init_training_params(config.seed, config)

    # fine-tune: overlay existing generator weights
    npz = voice_dir / "generator.npz"
    if npz.is_file():
        params = merge_pretrained(params, load_pytree_npz(npz))
        _LOGGER.info("Fine-tuning from %s", npz)
    state = init_train_state(
        to_torch_train_params(params, device),
        to_torch_train_params(disc_params, device),
        config,
        mesh=mesh,
    )

    ckpt_dir = Path(
        args.checkpoint_dir or (voice_dir / "checkpoints")
    ).absolute()
    start_step = 0
    if args.resume and ckpt_dir.is_dir():
        steps = sorted(
            int(p.name) for p in ckpt_dir.iterdir()
            if p.name.isdigit() and (p / CHECKPOINT_FILE).is_file()
        )
        if steps:
            start_step = steps[-1]
            state = load_checkpoint(ckpt_dir / str(start_step), config,
                                    device, mesh)
            _LOGGER.info("Resumed from step %d", start_step)

    steps_per_epoch = max(1, len(utterances) // batch_size)
    train_step = make_train_step(config, steps_per_epoch=steps_per_epoch)
    data = batches(utterances, config, batch_size, seed=config.seed)
    _LOGGER.info(
        "Training: %d steps, batch %d, on %s%s", args.steps, batch_size,
        torch.cuda.get_device_name(device) if device.type == "cuda"
        else device,
        "" if mesh is None else f" (rank {rank} of {world}, {device})",
    )
    # every rank iterates the same batch stream and keeps its rows
    local_start, local_size = process_local_batch_slice(batch_size, mesh)

    def rows(batch: TrainBatch) -> TrainBatch:
        return TrainBatch(*(
            None if t is None else t[local_start : local_start + local_size]
            for t in (batch.phoneme_ids, batch.text_lengths, batch.audio,
                      batch.spec_lengths, batch.speaker_ids)
        ))

    def checkpoint(path: Path, what: str) -> None:
        if leader:
            save_checkpoint(path, state)
            _LOGGER.info("%s: %s", what, path)
        barrier()

    def barrier() -> None:
        if mesh is not None:
            dist.barrier()

    generator = torch.Generator(device)
    t_start = time.time()
    for step_num in range(start_step, start_step + args.steps):
        batch = rows(next(data)).to(device)
        # each step's draws depend on (seed, step) only, as the
        # reference's fold_in(step_rng, step): a resumed run draws what an
        # uninterrupted one would, and every rank draws the same
        generator.manual_seed(mix_seed(config.seed + 1, step_num))
        state, metrics = train_step(state, batch, generator=generator)
        if (step_num + 1) % args.log_every == 0:
            vals = {k: float(f"{float(v):.7g}") for k, v in metrics.items()}
            rate = (step_num + 1 - start_step) / (time.time() - t_start)
            _LOGGER.info(
                "step %d %s (%.2f steps/s)", step_num + 1, vals, rate
            )
        if (step_num + 1) % args.checkpoint_every == 0:
            checkpoint(ckpt_dir / str(step_num + 1), "Checkpoint")

    # always checkpoint the FINAL step: when the run length isn't a
    # multiple of --checkpoint-every, a later --resume would otherwise
    # silently restart from an earlier step
    final_step = start_step + args.steps
    if final_step % args.checkpoint_every != 0:
        checkpoint(ckpt_dir / str(final_step), "Final checkpoint")

    if mesh is not None:
        # replicas that stepped identically hold identical parameters:
        # each rank logs a digest of its own, so a divergence shows
        _LOGGER.info("Final parameter digest (rank %d): %s", rank,
                     params_digest(state))

    if args.export:
        if leader:
            save_pytree_npz(voice_dir / "generator.npz",
                            export_params(state.params))
            _LOGGER.info("Exported %s", voice_dir / "generator.npz")
        barrier()

    print(json.dumps({"steps": args.steps, "final_step": state.step}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
