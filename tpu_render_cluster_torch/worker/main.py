"""Worker CLI entry point of the port: a render node on a CUDA GPU.

``python -m tpu_render_cluster_torch.worker.main --masterServerHost H
--masterServerPort P --baseDirectory D [--backend torch-raytrace|mock]``
connects to an unmodified master (the Python one or ``native/trc-master``)
over the reference's wire protocol, renders the frames or tiles it is given
through ``TorchRaytraceBackend`` and reports each one. SIGTERM drains: the
frame being rendered finishes, the rest of the queue goes back to the
master with the goodbye message. At exit the worker's span timeline and
metrics, with each kernel's launches, land under ``<baseDirectory>/obs/``.

The flag surface is the reference's (``tpu_render_cluster/worker/main.py``).
The renderer runs on the GPU; ``--device cpu`` runs the plain PyTorch
versions on the CPU instead, and without a GPU and without that flag the
worker raises before it connects. Flags of the reference that the port does
not have yet are accepted by the parser only to refuse them: a given one
exits with an error, so none appears to work while doing nothing.

``--sharding tile|spp`` splits each whole frame over every card of the
worker (``parallel/sharded_render.py``); ``--coordinatorAddress``,
``--numProcesses`` and ``--processId`` (or the reference's launcher
variables ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID``) first join the processes of several hosts into one
``torch.distributed`` group, whose mesh then spans their cards
(``parallel.mesh.initialize_multihost``). As in the reference, each process
of a group is a worker of its own towards the master, and the master hands
the processes different frames, while the sharded collectives pair every
process's shards of whatever frame each is on: each process would write a
frame mixed from the group's different frames, without an error. So
``--sharding tile|spp`` in a group of more than one process exits 2
(ROADMAP.md, section 3, item 6); a group without ``--sharding`` serves
frames as independent workers. Under sharding the mesh is every local
card, so ``--device`` may name only ``cuda`` or ``cpu``, not one card.
Sharding is kept for parity with the reference and buys no frames/s yet
(the host sets a sharded frame's time; PERF.md, section 6): a node's
cards render the most frames as one worker process each, ``--device
cuda:i``.

The BVH tiers are chosen, as in the reference, by the environment only:
``TRC_TLAS`` (the two-level walk, default on), ``TRC_BVH_QUANT`` (the node
format, 0, 1 or 2), ``TRC_BVH_BUILDER`` (``sah`` or ``median``) and
``TRC_BVH_WIDE`` (the BLAS width, 1 to 8). The backend resolves them once
per renderer (``integrator.resolve_bvh_config``); a worker started with
``TRC_BVH_QUANT=1`` renders that tier, and its launches count under the
quantized kernels' names in its metrics (``kernels.quant_name``).
"""

from __future__ import annotations

import argparse
import asyncio
import os
import signal
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from tpu_render_cluster_torch.obs import (
    export_chrome_trace,
    write_metrics_snapshot,
)
from tpu_render_cluster_torch.parallel.mesh import PROCESSES_ENV, initialize_multihost
from tpu_render_cluster_torch.protocol import messages as pm
from tpu_render_cluster_torch.render import kernels
from tpu_render_cluster_torch.utils.logging import initialize_console_and_file_logging
from tpu_render_cluster_torch.worker.backends import create_backend
from tpu_render_cluster_torch.worker.runtime import Worker

NOT_PORTED = "not yet in the port"

# dest -> the reference's flag, for the flags the port refuses.
_UNPORTED_FLAGS = {
    "telemetry_port": "--telemetryPort",
    "telemetry_host": "--telemetryHost",
    "router": "--router",
    "blender_binary": "--blenderBinary",
    "prepend_arguments": "--blenderPrependArguments",
    "append_arguments": "--blenderAppendArguments",
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="trc-worker-torch", description="Render cluster worker (PyTorch + CUDA)"
    )
    parser.add_argument("--masterServerHost", dest="master_host", required=True)
    parser.add_argument("--masterServerPort", dest="master_port", type=int, required=True)
    parser.add_argument("--baseDirectory", dest="base_directory", required=True)
    parser.add_argument("--logFilePath", dest="log_file_path", default=None)
    parser.add_argument(
        "--backend",
        choices=["torch-raytrace", "mock", "blender"],
        default="torch-raytrace",
        help="Render backend (default: torch-raytrace, the GPU path tracer; "
        f"blender is {NOT_PORTED}).",
    )
    parser.add_argument(
        "--device",
        default=None,
        help="torch-raytrace only: the device to render on (default: the "
        "current CUDA device; 'cpu' runs the plain versions on the CPU).",
    )
    parser.add_argument(
        "--renderSize",
        dest="render_size",
        default="512x512",
        help="torch-raytrace only: output WxH (default 512x512).",
    )
    parser.add_argument(
        "--renderSamples",
        dest="render_samples",
        type=int,
        default=8,
        help="torch-raytrace only: samples per pixel (default 8).",
    )
    parser.add_argument(
        "--wavefront",
        choices=["auto", "off", "force"],
        default=None,
        help="torch-raytrace only: the wavefront tier (render/compaction.py); "
        "the default, like auto, takes it for the scenes past the mesh "
        "megakernel's bound.",
    )
    parser.add_argument(
        "--raypool",
        choices=["auto", "off", "force"],
        default=None,
        help="torch-raytrace only: the device ray pool (render/raypool.py); "
        "the default, like auto, pools a deep-mesh job's frames queued on "
        "this worker (wire format unchanged). Takes precedence over "
        "--wavefront when both would fire.",
    )
    parser.add_argument(
        "--warmScene",
        dest="warm_scene",
        default=None,
        help="torch-raytrace only: build the kernels and render one frame of "
        "this scene BEFORE connecting to the master, so the job window holds "
        "no kernel build.",
    )
    parser.add_argument(
        "--sharding",
        choices=["none", "tile", "spp"],
        default="none",
        help="torch-raytrace only: split each frame across the worker's cards "
        "(tile = horizontal bands, spp = sample subsets summed and averaged; "
        "parallel/sharded_render.py).",
    )
    parser.add_argument(
        "--coordinatorAddress",
        dest="coordinator_address",
        default=None,
        help="torch-raytrace only: join a multi-host torch.distributed group "
        "whose process 0 listens at this host:port; with --numProcesses and "
        "--processId the worker's mesh then spans the cards of every host. "
        "Env fallbacks: JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / "
        "JAX_PROCESS_ID.",
    )
    parser.add_argument("--numProcesses", dest="num_processes", type=int, default=None)
    parser.add_argument("--processId", dest="process_id", type=int, default=None)
    parser.add_argument("--telemetryPort", dest="telemetry_port", help=NOT_PORTED)
    parser.add_argument("--telemetryHost", dest="telemetry_host", help=NOT_PORTED)
    parser.add_argument("--router", help=NOT_PORTED)
    parser.add_argument("--blenderBinary", dest="blender_binary", help=NOT_PORTED)
    parser.add_argument(
        "-p", "--blenderPrependArguments", dest="prepend_arguments", help=NOT_PORTED
    )
    parser.add_argument(
        "-a", "--blenderAppendArguments", dest="append_arguments", help=NOT_PORTED
    )
    return parser


def refuse_unported(args: argparse.Namespace, parser: argparse.ArgumentParser) -> None:
    """Exit with an error for a flag or backend the port does not have yet."""
    given = [flag for dest, flag in _UNPORTED_FLAGS.items() if getattr(args, dest) is not None]
    if args.backend == "blender":
        given.append("--backend blender")
    if given:
        parser.error(f"{', '.join(given)}: {NOT_PORTED}")


def refuse_sharding_conflicts(args: argparse.Namespace, parser: argparse.ArgumentParser) -> None:
    """Exit with an error for ``--sharding`` where it cannot render right:
    in a group of more than one process (the master hands each process its
    own frames, and the collectives would mix them), and with ``--device``
    naming one card (the mesh is every local card)."""
    if args.sharding == "none":
        return
    processes = args.num_processes
    if processes is None and os.environ.get(PROCESSES_ENV):
        processes = int(os.environ[PROCESSES_ENV])
    if processes is not None and processes > 1:
        parser.error(
            f"--sharding {args.sharding} in a group of {processes} processes: the master "
            "hands each process its own frames, so the sharded collectives would mix "
            "them (ROADMAP.md, section 3, item 6); run the group without --sharding"
        )
    if args.device is not None and torch.device(args.device).index is not None:
        parser.error(
            f"--sharding {args.sharding} renders on every local card: --device "
            f"{args.device} may name only cuda or cpu"
        )


def make_backend(args: argparse.Namespace):
    if args.backend == "mock":
        return create_backend("mock")
    # Before the backend: its mesh spans the group's cards.
    initialize_multihost(
        args.coordinator_address, args.num_processes, args.process_id, device=args.device
    )
    try:
        width, height = (int(v) for v in args.render_size.lower().split("x"))
    except ValueError as e:
        raise SystemExit(f"--renderSize must be WxH: {e}")
    return create_backend(
        "torch-raytrace",
        base_directory=args.base_directory,
        width=width,
        height=height,
        samples=args.render_samples,
        wavefront=args.wavefront,
        raypool=args.raypool,
        device=args.device,
        sharding=None if args.sharding == "none" else args.sharding,
    )


async def _run_worker(worker: Worker):
    """Run to completion with SIGTERM wired to a graceful drain.

    A terminated worker finishes the frame it is rendering, returns its
    queue to the master via the goodbye message, and exits cleanly, instead
    of vanishing and making the master pay a heartbeat-timeout eviction to
    rediscover the frames.
    """
    loop = asyncio.get_running_loop()
    try:
        loop.add_signal_handler(signal.SIGTERM, worker.request_drain)
    except (NotImplementedError, RuntimeError):  # non-Unix loop
        pass
    try:
        return await worker.connect_and_run_to_job_completion()
    finally:
        try:
            loop.remove_signal_handler(signal.SIGTERM)
        except (NotImplementedError, RuntimeError, ValueError):
            pass


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    refuse_unported(args, parser)
    refuse_sharding_conflicts(args, parser)
    initialize_console_and_file_logging(args.log_file_path)
    backend = make_backend(args)
    if args.warm_scene and args.backend == "torch-raytrace":
        backend.warm(args.warm_scene)
    # The launches the metrics snapshot reports are the job's alone.
    kernels.reset_counts()
    worker = Worker(args.master_host, args.master_port, backend)
    try:
        asyncio.run(_run_worker(worker))
    finally:
        # Export this process's obs artifacts even when the run died (the
        # partial timeline matters most in exactly those runs). File names
        # match the reference worker's, so the analysis suite pointed at
        # (or above) this directory loads them.
        obs_directory = Path(args.base_directory) / "obs"
        worker_name = f"worker-{pm.worker_id_to_string(worker.worker_id)}"
        try:
            export_chrome_trace(
                obs_directory / f"{worker_name}_trace-events.json",
                [worker.span_tracer],
            )
            # Each kernel wrapper's launches since the worker connected:
            # what shows that the job went through the kernels.
            write_metrics_snapshot(
                obs_directory / f"{worker_name}_metrics.json",
                worker.metrics,
                extra={"kernel_launches": dict(kernels.counts)},
            )
        except Exception as e:  # noqa: BLE001 - obs must not mask the run error
            print(f"warning: obs artifact export failed: {e}", file=sys.stderr)
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
