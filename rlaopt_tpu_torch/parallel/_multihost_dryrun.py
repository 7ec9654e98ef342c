"""Multi-process dryrun worker (see ``run_multiprocess_dryrun``).

Port of ``rlaopt_tpu/parallel/_multihost_dryrun.py``. Run as ``python -m
rlaopt_tpu_torch.parallel._multihost_dryrun <proc_id> <nproc> <port>
<device> <n_local>``: each process contributes ``n_local`` positions of
``device`` (``cpu``, or ``cuda``: card ``proc_id`` mod the card count) to a
``(nproc, n_local)`` 2-D mesh, and the sharded stack (Gram products in both
memory modes, a Nyström-PCG step, a SAP step on the sharded oracles) runs
across the process boundary. Every process draws the same data from one
seed and must end with the same bits of W. It prints its transport's
counters and its kernel launches by name (``launches {...}``).
"""

import json
import sys


def _check(a, b, what, tol=1e-4):
    err = float((a - b).abs().max() / b.abs().max())
    if not err <= tol:
        raise AssertionError(f"{what}: rel err {err:.2e} > {tol}")


def _same_on_every_rank(mesh, W, what):
    """W finite, and its bits on every process equal this one's."""
    import torch

    if not bool(torch.all(torch.isfinite(W))):
        raise AssertionError(f"{what}: W is not finite")
    for rank, other in enumerate(mesh.transport.all_gather(W)):
        if not torch.equal(other, W):
            raise AssertionError(f"{what}: rank {rank}'s W differs from rank "
                                 f"{mesh.transport.rank}'s")


def main(proc_id: int, nproc: int, port: int, device: str, n_local: int) -> None:
    import torch

    from rlaopt_tpu_torch.parallel.distributed import (
        initialize_multihost,
        make_mesh_2d,
        shutdown_multihost,
    )

    from rlaopt_tpu_torch.ops import kernel_cuda

    if device == "cuda":
        dev = torch.device("cuda", proc_id % torch.cuda.device_count())
        if not kernel_cuda.library_path().exists():
            raise RuntimeError("the kernels are not built: run_multiprocess_dryrun builds "
                               "them before it starts its processes")
    else:
        dev = torch.device(device)
    initialize_multihost(f"127.0.0.1:{port}", nproc, proc_id,
                         local_device_ids=[dev] * n_local, timeout=300)
    try:
        from rlaopt_tpu_torch.kernels import KernelConfig, ShardedRBFLinOp
        from rlaopt_tpu_torch.models import LinSys
        from rlaopt_tpu_torch.preconditioners import NystromConfig
        from rlaopt_tpu_torch.solvers import PCGConfig, SAPConfig

        mesh = make_mesh_2d(n_dcn=nproc, n_ici=n_local)
        axes = ("dcn", "i")

        n, d, k = 8 * nproc * n_local, 3, 2
        gen = torch.Generator().manual_seed(0)
        X = torch.randn((n, d), generator=gen).to(dev)
        B = torch.randn((n, k), generator=gen).to(dev)
        reg = 1e-2

        # Dense reference (replicated computation: every process agrees).
        K_dense = torch.exp(-0.5 * ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
        v = torch.ones((n,), device=dev)
        ref_mv = K_dense @ v

        # Replicated-memory sharded operator over the 2-D (dcn, ici) mesh.
        A = ShardedRBFLinOp(X, X, KernelConfig(lengthscale=1.0), mesh=mesh, axis=axes)
        _check(A @ v, ref_mv, "2-D sharded matvec")
        _check(v @ A, ref_mv, "2-D sharded adjoint (psum over dcn+ici)")

        # Ring mode: per-step rotation on the ICI axis, one DCN shift per cycle.
        A_ring = ShardedRBFLinOp(X, X, KernelConfig(lengthscale=1.0), mesh=mesh, axis=axes,
                                 memory_mode="ring")
        _check(A_ring @ v, ref_mv, "2-D hierarchical ring matvec")
        _check(A_ring.T @ v, ref_mv, "2-D hierarchical ring adjoint")

        # Full PCG training step across the process boundary.
        W, _ = LinSys(A, B, reg=reg).solve(
            PCGConfig(max_iters=1, rtol=1e-12,
                      precond_config=NystromConfig(rank=4, rho=reg)),
            torch.zeros_like(B), callback_freq=1, key=0,
        )
        _same_on_every_rank(mesh, W, "PCG step")

        # SAP training step on the sharded row and block oracles.
        sys_sap = LinSys(A, B, reg=reg, A_row_oracle=A.row_oracle, A_blk_oracle=A.blk_oracle)
        W2, _ = sys_sap.solve(
            SAPConfig(max_iters=1, rtol=1e-12, blk_sz=4, accel=False,
                      precond_config=NystromConfig(rank=4, rho=reg)),
            torch.zeros_like(B), callback_freq=1, key=0,
        )
        _same_on_every_rank(mesh, W2, "SAP step")
        t = mesh.transport
        print(f"transport {t.name}: {t.calls} collectives, {t.seconds:.3f} s, "
              f"{t.bytes} bytes sent", flush=True)
        print("launches " + json.dumps(kernel_cuda.launch_counts()), flush=True)
        print("MULTIHOST_OK", flush=True)
    finally:
        shutdown_multihost()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], int(sys.argv[5]))
