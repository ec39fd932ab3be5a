"""Multi-process execution helpers (torch.distributed).

PyTorch counterpart of ``sdrtpu/shard/multihost.py``.  Every process
calls `init_distributed` before it builds a mesh (`mesh.make_mesh`):
NCCL with one card per process, or gloo on the CPU.  Nothing in a
machine tells a process of its peers, so the caller gives the
rendezvous address (``tcp://host:port`` or ``file:///path``), the
process count and this process's rank.

`run_processes` runs one function in N fresh processes, one rank each:
gloo on the CPU (the counterpart of the reference's virtual CPU
devices; it rendezvouses through a ``file://`` store under a given
directory, so parallel test workers never race for a TCP port) or NCCL
with one card per rank.

Scaling measurement: `scaling_efficiency` times a step on one device and
on the whole mesh and reports the weak-scaling efficiency t1 / tN.
`dryrun_multichip` runs the sharded flagship on N ranks against the
unsharded pipeline.
"""

from __future__ import annotations

import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> None:
    """Join the process group: NCCL when CUDA is there (each rank on card
    ``process_id % device_count``, set before any collective), else gloo.

    ``coordinator_address``: ``tcp://host:port``, ``file:///path``, a
    bare ``host:port`` or None (``env://``: ``MASTER_ADDR`` and
    ``MASTER_PORT``).  A single process (``num_processes`` None or 1)
    joins nothing, as the reference; under NCCL it still takes its card.
    """
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: NCCL needs a CUDA card")
        torch.cuda.set_device((process_id or 0) % torch.cuda.device_count())
    if num_processes is None or num_processes <= 1:
        return
    address = coordinator_address or "env://"
    if "://" not in address:
        address = f"tcp://{address}"
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=address,
                            world_size=num_processes, rank=process_id, **kw)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def measure(fn, *args, reps: int = 3) -> float:
    """Best wall-clock seconds of ``fn(*args)``, each call ended by a
    device synchronisation."""
    fn(*args)  # warm
    _sync()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best


def scaling_efficiency(step_1dev, step_ndev, args1, argsn, n_devices: int,
                       reps: int = 3) -> dict:
    """WEAK-scaling comparison: equal work per device.

    ``step_1dev(*args1)`` does W units of work on one device;
    ``step_ndev(*argsn)`` does ``n_devices * W`` sharded over n devices,
    so each device again does W.  Perfect scaling gives tN == t1, and
    ``t1 / tN`` is the fraction not lost to collectives, halo and
    imbalance.  Every rank calls this together (``step_ndev`` runs
    collectives).
    """
    t1 = measure(step_1dev, *args1, reps=reps)
    tn = measure(step_ndev, *argsn, reps=reps)
    return {
        "t_single": t1,
        "t_sharded": tn,
        "n_devices": n_devices,
        "weak_scaling_efficiency": t1 / tn if tn > 0 else float("inf"),
    }


def _rank_main(call_path, rank, n, address, device, results):
    """One spawned rank: load ``(fn, args)``, join, run ``fn(*args)``,
    report, leave."""
    try:
        with open(call_path, "rb") as f:  # written by run_processes
            fn, args = pickle.load(f)
        if device == "cpu":
            torch.set_num_threads(1)
        init_distributed(address, n, rank,
                         backend="gloo" if device == "cpu" else "nccl")
        out = fn(*args)
        results.put((rank, "ok", out))
    except BaseException:  # reported to the parent, which stops the rest
        results.put((rank, "error", traceback.format_exc()))
        raise
    if dist.is_initialized():
        dist.destroy_process_group()


def run_processes(fn, n: int, workdir=None, args=(), device: str = "cuda",
                  timeout: float = 300.0) -> list:
    """``fn(*args)`` in ``n`` fresh processes, one rank each; returns the
    ranks' results in rank order.

    ``device``: "cuda" (NCCL, rank r on card r; needs n cards) or "cpu"
    (gloo, one thread a process).  The processes rendezvous through a
    ``file://`` store in ``workdir`` (a new temporary directory when
    None).  ``fn`` and its arguments and result must pickle; ``fn`` runs
    under the ``spawn`` start method, so it lives at a module's top level
    and its module imports only what the ranks need.  ``(fn, args)`` is
    pickled once to a file in ``workdir`` that every rank loads: passed
    as a process argument, a large one would hold each start until the
    rank before had read it.  Raises with the rank's traceback when a
    rank fails, and ``TimeoutError`` when the ranks are not done within
    ``timeout`` seconds; either way every process started is ended.
    """
    import multiprocessing as mp

    if device not in ("cpu", "cuda"):
        raise ValueError(f"run_processes: unsupported device {device!r}")
    if device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"run_processes: {n} NCCL ranks need {n} cards, "
                           f"have {torch.cuda.device_count()}")
    own_dir = None
    if workdir is None:
        own_dir = tempfile.TemporaryDirectory()
        workdir = own_dir.name
    stem = os.path.join(os.path.abspath(workdir),
                        f"ranks-{os.getpid()}-{time.monotonic_ns()}")
    call = pickle.dumps((fn, args))
    with open(stem + ".call", "wb") as f:
        f.write(call)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(stem + ".call", r, n, f"file://{stem}.store",
                               device, results), daemon=True)
             for r in range(n)]
    out: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"run_processes: {n - len(out)} of {n} ranks not done "
                    f"after {timeout} s")
            try:
                rank, status, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                # a rank that died before it could report (killed, or
                # failed while starting) never will
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead and results.empty():
                    code = procs[dead[0]].exitcode
                    raise RuntimeError(
                        f"run_processes: rank {dead[0]} exited with code "
                        f"{code} before reporting") from None
                continue
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        results.close()
        os.remove(stem + ".call")
        if own_dir is not None:
            own_dir.cleanup()
    return [out[r] for r in range(n)]


# -- the sharded flagship's dry run ---------------------------------------


def _dryrun_signal(offsets, fs, n) -> np.ndarray:
    """A WFM station (pilot and stereo subcarrier) at every offset, as the
    reference's dry run: the equality check means nothing on noise."""
    t = np.arange(n) / fs
    x = np.zeros(t.shape, np.complex128)
    for i, f0 in enumerate(offsets):
        mpx = (0.45 * np.sin(2 * np.pi * (400.0 + 100.0 * i) * t)
               + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
               + 0.45 * np.sin(2 * np.pi * 600.0 * t)
               * np.sin(2 * np.pi * 38000.0 * t))
        ph = np.cumsum(2 * np.pi * 75000.0 * mpx / fs)
        x += (0.9 / len(offsets)) * np.exp(1j * (2 * np.pi * f0 * t + ph))
    return x.astype(np.complex64)


def dryrun_rank(n_devices: int, device: str = "cuda") -> dict:
    """One rank of `dryrun_multichip` (its process group joined)."""
    from ..apps.wbfm_pipeline import WbfmMultiVfoPipeline
    from .flagship import ShardedWbfmPipeline
    from .mesh import all_gather, make_mesh, shard_channel_state

    n_time = 2 if (n_devices >= 4 and n_devices % 2 == 0) else 1
    n_channel = n_devices // n_time
    mesh = make_mesh(n_channel=n_channel, n_time=n_time,
                     device="cpu" if device == "cpu" else None)
    fs_in = 2_000_000.0  # integer ratio to the 250 kHz WFM IF
    n_vfo = max(8, n_channel)
    n_vfo -= n_vfo % n_channel
    # at least 2 quanta a block: 4 blocks must clear the pilot filter's
    # fill transient before the equality check
    block_len = WbfmMultiVfoPipeline.block_multiple(fs_in) * max(2, n_time)
    offsets = np.linspace(-0.4, 0.4, n_vfo) * fs_in
    sharded = ShardedWbfmPipeline(offsets, fs_in, block_len, mesh)
    state = shard_channel_state(mesh, sharded.init_state(), n_vfo)
    n_blocks = 4
    x = _dryrun_signal(offsets, fs_in, n_blocks * block_len)
    with torch.inference_mode():
        for blk in x.reshape(n_blocks, block_len):
            state, audio = sharded(state, blk)
        audio = all_gather(mesh, audio, "channel", dim=1)
        if mesh.rank != 0:
            return {}
        pipe = WbfmMultiVfoPipeline(offsets, fs_in, block_len,
                                    channelizer_method="fft",
                                    device=mesh.device)
        st_u = pipe.init_state()
        for blk in x.reshape(n_blocks, block_len):
            st_u, ref = pipe(st_u, torch.as_tensor(blk, device=mesh.device))
    n_audio = pipe.out_len(block_len)
    assert tuple(audio.shape) == (2, n_vfo, n_audio), (audio.shape, n_audio)
    # steady state only: blocks 0-1 are the filter-fill transient
    err = float((audio - ref).abs().max())
    assert err < 1e-4, f"sharded flagship mismatch: {err}"
    return {"mesh": [n_channel, n_time], "n_vfo": n_vfo,
            "block_len": block_len, "audio_shape": list(audio.shape),
            "max_abs_err": err}


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     workdir=None) -> dict:
    """Run the sharded flagship on ``n_devices`` ranks (tiny shapes).

    Counterpart of the reference's ``__graft_entry__.dryrun_multichip``:
    the same mesh rule (``n_time = 2`` where n >= 4 and even), 8 VFOs
    off 2 Msps, blocks of two pipeline quanta (or ``n_time``), four
    blocks; `ShardedWbfmPipeline` (the FFT front time- and channel-
    sharded with the halo exchange, the WFM back end channel-sharded)
    held to the unsharded `WbfmMultiVfoPipeline` on the last block within
    1e-4.  ``device`` "cuda": NCCL, one card a rank; "cpu": gloo
    processes.  Returns rank 0's summary.
    """
    res = run_processes(dryrun_rank, n_devices, workdir,
                        args=(n_devices, device), device=device)[0]
    print(f"dryrun_multichip OK: mesh=({res['mesh'][0]}x{res['mesh'][1]}), "
          f"flagship WbfmMultiVfoPipeline, {res['n_vfo']} VFOs, block "
          f"{res['block_len']} -> {tuple(res['audio_shape'])}, steady-state "
          f"err {res['max_abs_err']:.2e}")
    return res
