"""The multi-process runtime and the 2-D ``("dcn", "i")`` mesh.

Port of ``rlaopt_tpu/parallel/distributed.py``. JAX joins processes with
``jax.distributed.initialize`` and runs one program in all of them over a
mesh of every process's devices; the port does the same over
``torch.distributed``:

* :func:`initialize_multihost` joins the process group (explicit
  arguments, or what ``torchrun`` sets) and chooses the transport of the
  cross-process collectives from the layout: NCCL when each process holds
  cards of its own, gloo staged through pinned host memory when processes
  share a card or hold CPU positions;
* :func:`make_mesh_2d` (and :func:`~rlaopt_tpu_torch.parallel.make_mesh`)
  then build meshes over every process's positions, process r owning row r
  (JAX sorts devices by ``(process_index, id)``);
* :func:`run_multiprocess_dryrun` spawns N fresh interpreters × M positions
  each and drives a sharded solve across them
  (``rlaopt_tpu_torch.parallel._multihost_dryrun``).

Every process runs the same script on the same replicated state; only the
collectives of :mod:`rlaopt_tpu_torch.parallel.mesh` cross processes.
"""

import dataclasses
import datetime
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from typing import Optional, Sequence

import torch

from .mesh import Mesh, Transport


__all__ = [
    "initialize_multihost",
    "make_mesh_2d",
    "axis_size",
    "run_multiprocess_dryrun",
    "process_index",
    "process_count",
    "shutdown_multihost",
]

_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


@dataclasses.dataclass
class _Runtime:
    """The process group this process joined: its transport and the
    devices of its positions."""

    transport: Transport
    local_devices: list


# The runtime this process joined (None: single-process). Like
# torch.distributed's default group, it is one per process.
_runtime: Optional[_Runtime] = None


def _local_devices(local_device_ids) -> list:
    """This process's positions: ``local_device_ids`` names CUDA ordinals
    (ints, repeats allowed: ``[0, 0]`` is two positions of ``cuda:0``) or
    devices (``"cpu"``); default one position of ``cuda:LOCAL_RANK`` (mod the
    card count) under ``torchrun``, else one of every CUDA device."""
    if local_device_ids is not None:
        devices = [torch.device("cuda", d) if isinstance(d, int) else torch.device(d)
                   for d in local_device_ids]
        if not devices:
            raise ValueError("local_device_ids names no device")
        return devices
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError(
            "initialize_multihost: no CUDA device is available; pass "
            "local_device_ids=['cpu'] * M for M CPU positions"
        )
    if "LOCAL_RANK" in os.environ:
        return [torch.device("cuda", int(os.environ["LOCAL_RANK"]) % count)]
    return [torch.device("cuda", i) for i in range(count)]


def _layout(devices) -> tuple:
    """What decides the transport: this host, and each position's card
    (its UUID) or None for a CPU position."""
    cards = [str(torch.cuda.get_device_properties(d).uuid) if d.type == "cuda" else None
             for d in devices]
    return socket.gethostname(), cards


def _choose_transport(layouts) -> str:
    """NCCL when every position of every process is on a card and no card
    is held by two processes; else gloo (staged through the host)."""
    owner = {}
    for rank, (host, cards) in enumerate(layouts):
        for card in cards:
            if card is None or owner.setdefault((host, card), rank) != rank:
                return "gloo"
    return "nccl" if torch.distributed.is_nccl_available() else "gloo"


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
    cpu_collectives: Optional[str] = "gloo",
    timeout: float = 600.0,
) -> None:
    """Join a multi-process runtime.

    ``coordinator_address`` (``"host:port"``, process 0 listens there),
    ``num_processes`` and ``process_id`` go together; with all three None
    they are read from ``torchrun``'s ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``, and with none of those set the process
    warns and stays single-process (the same script runs on one host and
    on many). An incomplete set raises before anything waits on a socket.
    ``local_device_ids``: this process's positions (see
    :func:`_local_devices`). ``cpu_collectives``: the CPU collectives'
    backend, gloo. ``timeout``: seconds any collective may wait before it
    raises (a rank that never arrives is a failure, not a hang).
    """
    global _runtime
    if cpu_collectives not in (None, "gloo"):
        raise ValueError(f"cpu_collectives {cpu_collectives!r}: the port has gloo")
    if _runtime is not None:
        raise RuntimeError("initialize_multihost(): this process already joined a runtime")
    given = {"coordinator_address": coordinator_address, "num_processes": num_processes,
             "process_id": process_id}
    if all(v is None for v in given.values()):
        env = {k: os.environ.get(k) for k in _TORCHRUN_ENV}
        if all(v is None for v in env.values()):
            if local_device_ids is not None:
                raise ValueError(
                    "initialize_multihost(): local_device_ids without a cluster; pass "
                    "coordinator_address, num_processes and process_id"
                )
            warnings.warn(
                "initialize_multihost(): no cluster environment detected; "
                "running single-process.",
                stacklevel=2,
            )
            return
        missing = [k for k, v in env.items() if v is None]
        if missing:
            raise ValueError(f"initialize_multihost(): {', '.join(missing)} unset "
                             f"(torchrun sets all of {', '.join(_TORCHRUN_ENV)})")
        address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        missing = [k for k, v in given.items() if v is None]
        if missing:
            raise ValueError(
                f"initialize_multihost(): {', '.join(missing)} missing: pass "
                "coordinator_address, num_processes and process_id together"
            )
        address = coordinator_address
        num_processes, process_id = int(num_processes), int(process_id)
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} of {num_processes} processes")
    if address.startswith("tcp://"):
        address = address[len("tcp://"):]
    devices = _local_devices(local_device_ids)
    wait = datetime.timedelta(seconds=timeout)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{address}", rank=process_id,
                            world_size=num_processes, timeout=wait)
    layouts = [None] * num_processes
    dist.all_gather_object(layouts, _layout(devices))
    name, group = _choose_transport(layouts), None
    if name == "nccl":
        torch.cuda.set_device(devices[0])
        group = dist.new_group(backend="nccl", timeout=wait)
        dist.barrier(group=group, device_ids=[devices[0].index])
    _runtime = _Runtime(Transport(name, process_id, num_processes, group), devices)


def shutdown_multihost() -> None:
    """Leave the runtime (a no-op in a single process)."""
    global _runtime
    if _runtime is None:
        return
    import torch.distributed as dist

    dist.destroy_process_group()
    _runtime = None


def process_index() -> int:
    """This process's rank (0 in a single process)."""
    return 0 if _runtime is None else _runtime.transport.rank


def process_count() -> int:
    """The number of processes of the runtime (1 in a single process)."""
    return 1 if _runtime is None else _runtime.transport.world


def _multiprocess_mesh(devices, axis_names, grid) -> Optional[Mesh]:
    """After :func:`initialize_multihost`: the mesh of ``grid`` over every
    process's positions (its last None entry filled in, and a 2-D grid's
    first with the process count), ``devices`` this process's (default:
    those it joined with), process r owning the r-th run of positions. None
    in a single process."""
    if _runtime is None:
        return None
    local = list(_runtime.local_devices if devices is None else devices)
    world = _runtime.transport.world
    total = world * len(local)
    grid = list(grid)
    if len(grid) == 2 and grid[0] is None:
        grid[0] = world
    if grid[-1] is None:
        grid[-1] = total // math.prod(grid[:-1])
    if math.prod(grid) != total:
        raise ValueError(
            f"a mesh over {world} processes spans all their {total} positions "
            f"({len(local)} each); asked for {tuple(grid)}"
        )
    return Mesh([local[p % len(local)] for p in range(total)], axis_names, grid,
                owners=[p // len(local) for p in range(total)], transport=_runtime.transport)


def make_mesh_2d(
    n_dcn: Optional[int] = None,
    n_ici: Optional[int] = None,
    dcn_axis: str = "dcn",
    ici_axis: str = "i",
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A 2-D ``(dcn_axis, ici_axis)`` mesh of ``n_dcn x n_ici`` positions.

    Rows are processes (their collectives cross the process boundary),
    columns the positions within one. Defaults: one row per process, all
    of a process's positions in its row. In a single process: one row, all
    positions of ``devices`` (every CUDA device when None), extra devices
    left out. After :func:`initialize_multihost` the mesh spans every
    process's positions, ``devices`` naming this process's.
    """
    spanning = _multiprocess_mesh(devices, (dcn_axis, ici_axis), (n_dcn, n_ici))
    if spanning is not None:
        return spanning
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(
                "make_mesh_2d: no CUDA device is available; pass devices=[...]"
            )
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = list(devices)
    if n_dcn is None:
        n_dcn = 1
    if n_ici is None:
        n_ici = len(devices) // n_dcn
    if n_dcn * n_ici > len(devices):
        raise ValueError(
            f"mesh {n_dcn}x{n_ici} needs {n_dcn * n_ici} devices, "
            f"have {len(devices)}"
        )
    return Mesh(devices[: n_dcn * n_ici], (dcn_axis, ici_axis), (n_dcn, n_ici))


def axis_size(mesh: Mesh, axis) -> int:
    """Total position count along ``axis`` (a name or tuple of names)."""
    if isinstance(axis, (tuple, list)):
        size = 1
        for a in axis:
            size *= mesh.shape[a]
        return size
    return mesh.shape[axis]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_children(argvs, timeout: float, env: Optional[dict] = None) -> list:
    """Run one fresh interpreter per argument list (``python <argv...>``),
    all at once, under one deadline; returns each one's output (stdout and
    stderr). Raises with the tail of every child's output if a child fails
    or outlives ``timeout`` seconds; no child outlives the call."""
    env = dict(os.environ if env is None else env)
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    deadline = time.monotonic() + timeout
    logs, procs = [], []
    try:
        for argv in argvs:
            logs.append(tempfile.TemporaryFile(mode="w+"))
            procs.append(subprocess.Popen([sys.executable, *argv], env=env, stdout=logs[-1],
                                          stderr=subprocess.STDOUT, text=True))
        late = False
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.0))
            except subprocess.TimeoutExpired:
                late = True
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outputs = []
    for log in logs:
        log.seek(0)
        outputs.append(log.read())
        log.close()
    if late or any(p.returncode != 0 for p in procs):
        why = (f"timed out after {timeout:.0f} s" if late
               else f"exit codes {[p.returncode for p in procs]}")
        raise RuntimeError(f"multi-process run failed ({why}):\n"
                           + "\n---\n".join(o[-2000:] for o in outputs))
    return outputs


def run_multiprocess_dryrun(
    n_procs: int = 2, n_local: int = 4, timeout: int = 600, device=None
) -> list:
    """Drive the full multi-process path: ``n_procs`` fresh interpreters ×
    ``n_local`` positions each, joined through :func:`initialize_multihost`,
    running sharded Gram products, a Nyström-PCG step and a SAP step over
    a 2-D ``(dcn, i)`` mesh (``_multihost_dryrun.py``). ``device``: the
    positions' device, the card (``cuda:0``, or card r for process r where
    there are as many) unless the caller names ``"cpu"``.

    Raises on any process failure, timeout or numerical mismatch, with the
    tail of every child's output; returns each child's output.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "run_multiprocess_dryrun: no CUDA device is available; pass device='cpu'"
            )
        device = "cuda"
    device = str(device)
    if device != "cpu":
        from ..ops import kernel_cuda

        kernel_cuda.build()  # once, here: the processes load it
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in _TORCHRUN_ENV}
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    outputs = run_children(
        [["-m", "rlaopt_tpu_torch.parallel._multihost_dryrun", str(pid), str(n_procs),
          str(port), device, str(n_local)] for pid in range(n_procs)],
        timeout, env,
    )
    missing = [pid for pid, out in enumerate(outputs) if "MULTIHOST_OK" not in out]
    if missing:
        raise RuntimeError(
            f"multi-process dryrun: processes {missing} did not print MULTIHOST_OK:\n"
            + "\n---\n".join(o[-2000:] for o in outputs)
        )
    return outputs
