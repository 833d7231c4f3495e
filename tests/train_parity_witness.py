"""Second witness for the train-step parity bar on the CPU: which side moves
when the same first step runs under other reduction orders.

The multi-speaker tiny config (4 speakers, ``gin_channels`` 16) takes one
step on 4 rows with 4 speakers (``torch_train_reference.batch_arrays``)
from one initial state, saved once: the reference's own jitted
``init_train_state`` (``--init reference``) or the port's
(``--init port``), the decoder's gains scaled as in the parity tests.
Then, each in a process of its own so that its settings hold:

- the reference's step (``reference_step``, jitted) under XLA's default
  CPU threading, with 8 virtual devices (the test suite's flag), and with
  Eigen single-threaded;
- the port's step with 1, 4 and 8 torch threads;
- the port's step in float64 (every parameter, input and draw, and the
  float32 islands of the step patched to float64 in that process only;
  the float32 results left in it are counted and printed).

Prints, for every pair of runs, the worst generator-gradient relative L2
error, its tensor, and how many tensors pass 1e-3.

    JAX_PLATFORMS=cpu python tests/train_parity_witness.py \\
        --init reference --out /tmp/witness
"""

import argparse
import glob
import itertools
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
MODEL = dict(n_speakers=4, gin_channels=16)
ROWS = SPEAKERS = 4
XLA = {
    "default": None,
    "dev8": "--xla_force_host_platform_device_count=8",
    "eigen1": "--xla_cpu_multi_thread_eigen=false "
              "intra_op_parallelism_threads=1",
}
PORT = ("1", "4", "8", "1:f64")


def _lib():
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    import torch_train_reference as ref_lib
    return ref_lib


def _state(out: Path, ref_lib):
    trees = [ref_lib.unflat(dict(np.load(out / f"state_{k}.npz")))
             for k in ("params", "disc")]
    return types.SimpleNamespace(params=trees[0], disc_params=trees[1])


def init(out: Path, which: str) -> None:
    ref_lib = _lib()
    state = (
        ref_lib.port_initial_state(ref_lib.config(port=True, model=MODEL))
        if which == "port"
        else ref_lib.initial_state(ref_lib.config(model=MODEL))
    )
    for key, tree in (("params", state.params), ("disc", state.disc_params)):
        np.savez(out / f"state_{key}.npz", **ref_lib.flat(ref_lib.host(tree)))


def reference(out: Path, label: str) -> None:
    ref_lib = _lib()
    import jax

    b = ref_lib.batch_arrays(rows=ROWS, n_speakers=SPEAKERS)
    _, grads_g, _ = ref_lib.reference_step(
        ref_lib.config(model=MODEL), _state(out, ref_lib), b,
        jax.random.PRNGKey(1),
    )
    np.savez(out / f"g_ref_{label}.npz", **ref_lib.flat(grads_g))


def _float64_everywhere(torch, ttrain) -> None:
    """Patch, in this process only, the step's float32 islands (the
    decoder's dtype, the final conv, LayerNorm's and the KL's
    ``.float()``, the STFT basis) to float64."""
    from mimic3_tpu_torch.models.vits import hifigan
    from mimic3_tpu_torch.ops import stft

    torch.set_default_dtype(torch.float64)
    on_device = stft._on_device
    stft._on_device = lambda *a: on_device(*a).double()
    torch.Tensor.float = lambda self, *a, **k: self.double()
    conv1d = hifigan.conv1d
    hifigan.conv1d = lambda x, p, *a, dtype=None, **k: conv1d(x, p, *a, **k)
    model = ttrain.VitsModel
    ttrain.VitsModel = lambda cfg, decoder_dtype=None, **k: model(
        cfg, decoder_dtype=torch.float64, **k)


def port(out: Path, spec: str) -> None:
    ref_lib = _lib()
    import jax
    import torch

    from mimic3_tpu_torch.models.vits import train as ttrain
    from mimic3_tpu_torch.runtime.convert import to_jax_layout

    threads, _, dtype = spec.partition(":")
    torch.set_num_threads(int(threads))
    state0 = _state(out, ref_lib)
    b = ref_lib.batch_arrays(rows=ROWS, n_speakers=SPEAKERS)
    tcfg = ref_lib.config(port=True, model=MODEL, learning_rate=0.0)
    noise = ref_lib.reference_noise(jax.random.PRNGKey(1), b, tcfg)
    batch = ref_lib.t_batch(b)
    params = ref_lib.carry(state0.params)
    disc = ref_lib.carry(state0.disc_params)
    if dtype == "f64":
        _float64_everywhere(torch, ttrain)

        def wide(tree):
            return {k: wide(v) if isinstance(v, dict)
                    else v.double() if v.is_floating_point() else v
                    for k, v in tree.items()}

        params, disc = wide(params), wide(disc)
        noise = ttrain.TrainNoise(noise.posterior.double(),
                                  noise.duration.double(), noise.starts)
        batch.audio = batch.audio.double()
    state = ttrain.init_train_state(params, disc, tcfg)
    step = ttrain.make_train_step(tcfg)
    if dtype == "f64":
        from torch.overrides import TorchFunctionMode

        narrow = []

        class CountFloat32(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                result = func(*args, **(kwargs or {}))
                if getattr(result, "dtype", None) == torch.float32:
                    narrow.append(getattr(func, "__name__", str(func)))
                return result

        with CountFloat32():
            state, _ = step(state, batch, noise=noise)
        print(f"float32 results in the float64 step: {len(narrow)} "
              f"({sorted(set(narrow))})", flush=True)
    else:
        state, _ = step(state, batch, noise=noise)
    grads = ref_lib.flat(to_jax_layout(ref_lib.unflat(
        {n: t.grad.to(torch.float32) for n, t in state.g_leaves})))
    label = f"t{threads}" + (f"_{dtype}" if dtype else "")
    np.savez(out / f"g_port_{label}.npz", **grads)


def compare(out: Path) -> None:
    ref_lib = _lib()
    runs = {Path(p).stem[2:]: dict(np.load(p))
            for p in sorted(glob.glob(str(out / "g_*.npz")))}
    for a, c in itertools.combinations(sorted(runs), 2):
        errs = []
        for name, want in runs[a].items():
            norm = np.linalg.norm(want)
            if norm and not ref_lib.zero_gradient_in_exact_arithmetic(name):
                errs.append((np.linalg.norm(runs[c][name] - want) / norm,
                             name))
        worst, name = max(errs)
        print(f"{a:>12} vs {c:<12} worst rel L2 {worst:.3e} at {name}; "
              f"tensors past 1e-3: {sum(e > 1e-3 for e, _ in errs)}",
              flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--init", choices=("reference", "port"),
                        default="reference")
    parser.add_argument("--out", required=True)
    parser.add_argument("--run", nargs=2, help=argparse.SUPPRESS)
    args = parser.parse_args()
    out = Path(args.out)
    if args.run:
        what, arg = args.run
        {"init": init, "ref": reference, "port": port}[what](out, arg)
        return
    out.mkdir(parents=True, exist_ok=True)
    for stale in out.glob("g_*.npz"):
        stale.unlink()

    def run(what, arg, xla=None):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("XLA_FLAGS", None)
        if xla:
            env["XLA_FLAGS"] = xla
        t0 = time.time()
        subprocess.run([sys.executable, __file__, "--out", str(out),
                        "--run", what, arg], env=env, check=True)
        print(f"{what} {arg}: {time.time() - t0:.1f} s", flush=True)

    run("init", args.init)
    for label, flags in XLA.items():
        run("ref", label, flags)
    for spec in PORT:
        run("port", spec)
    compare(out)


if __name__ == "__main__":
    main()
