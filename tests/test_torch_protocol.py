"""The port's wire protocol against the reference's, byte for byte.

For every message class of ``tpu_render_cluster/protocol/messages.py`` a
seeded instance is built in both packages from the same values, once with
every optional field set (epoch, tile, job id, trace context, metrics
payload, errored result, ...) and once bare, as a reference-shaped peer
sends it. The port's ``encode_message`` must give the reference's text
exactly, and each package must decode the other's text to a message equal
to its own. ``WorkerTrace`` and the handshake's ``PROTOCOL_VERSION`` are
held the same way.
"""

from __future__ import annotations

import dataclasses
import json
import random

import pytest

import tpu_render_cluster as ref_pkg
import tpu_render_cluster_torch as port_pkg
from tpu_render_cluster.jobs import models as ref_models
from tpu_render_cluster.obs.registry import MetricsRegistry as RefRegistry
from tpu_render_cluster.protocol import messages as ref_pm
from tpu_render_cluster.traces import worker_trace as ref_traces
from tpu_render_cluster_torch.jobs import models as port_models
from tpu_render_cluster_torch.obs.registry import MetricsRegistry as PortRegistry
from tpu_render_cluster_torch.protocol import messages as port_pm
from tpu_render_cluster_torch.traces import worker_trace as port_traces

CLASS_NAMES = [cls.__name__ for cls in ref_pm.ALL_MESSAGE_TYPES]

FULL_JOB = {
    "job_name": "03_physics-2-mesh",
    "job_description": "protocol parity job",
    "project_file_path": "%BASE%/project.blend",
    "render_script_path": "%BASE%/script.py",
    "frame_range_from": 1,
    "frame_range_to": 240,
    "wait_for_number_of_workers": 8,
    "frame_distribution_strategy": {
        "strategy_type": "dynamic",
        "target_queue_size": 4,
        "min_queue_size_to_steal": 2,
        "min_seconds_before_resteal_to_elsewhere": 40,
        "min_seconds_before_resteal_to_original_worker": 80,
    },
    "output_directory_path": "%BASE%/frames",
    "output_file_name_format": "rendered-####",
    "output_file_format": "PNG",
    "render_backend": "tpu-raytrace",
    "tiles": [2, 2],
    "slo": {"unit_latency_p99_seconds": 0.5, "deadline_seconds": 600.0},
}

BARE_JOB = {
    key: value
    for key, value in FULL_JOB.items()
    if key not in ("render_backend", "tiles", "slo")
} | {"frame_distribution_strategy": {"strategy_type": "naive-fine"}}


def _worker_trace(traces, rng: random.Random, *, frames: int):
    collector = traces.WorkerTraceBuilder()
    start = rng.uniform(1.7e9, 1.8e9)
    collector.set_job_start_time(start)
    for frame in range(1, frames + 1):
        points = sorted(start + rng.uniform(0.0, 100.0) for _ in range(7))
        collector.increment_total_queued_frames()
        collector.trace_new_rendered_frame(frame, traces.FrameRenderTime(*points))
    collector.increment_total_frames_removed_from_queue()
    collector.trace_new_ping(start + 1.25, start + 1.5)
    collector.trace_new_reconnect(start + 2.0, start + 2.75)
    collector.set_job_finish_time(start + 200.0)
    return collector.build()


def _metrics_payload(registry_cls, rng: random.Random) -> dict:
    registry = registry_cls()
    registry.counter("worker_frames_rendered_total", "frames").inc(3)
    registry.gauge("render_frames_per_second", "fps").set(rng.uniform(1.0, 60.0))
    histogram = registry.histogram(
        "worker_frame_phase_seconds", "phases", labels=("phase",)
    )
    for phase in ("queue_wait", "read", "render", "write"):
        histogram.observe(rng.uniform(1e-3, 2.0), phase=phase)
    return registry.to_wire()


def _values(pm, models, traces, registry_cls, cls_name: str, *, full: bool, seed: int) -> dict:
    """Constructor arguments of one message, the same for either package
    given the same seed."""
    rng = random.Random(seed)
    trace = pm.TraceContext(rng.getrandbits(64), rng.getrandbits(64))
    values = {
        "server_version": "1.0.0",
        "worker_version": "1.0.0",
        "handshake_type": pm.HANDSHAKE_TYPE_RECONNECTING,
        "worker_id": rng.getrandbits(32),
        "ok": True,
        "message_request_id": rng.getrandbits(64),
        "message_request_context_id": rng.getrandbits(64),
        "job": models.BlenderJob.from_dict(FULL_JOB if full else BARE_JOB),
        "job_name": "03_physics-2-mesh",
        "frame_index": rng.randint(1, 240),
        "request_time": rng.uniform(1.7e9, 1.8e9),
        "last_seq": rng.randint(0, 10_000),
        "primary_seq": rng.randint(0, 10_000),
        "seq": rng.randint(0, 10_000),
        "epoch": rng.randint(1, 9),
        "record": {"op": "unit_finished", "frame": rng.randint(1, 240)},
        "host": "127.0.0.1",
        "port": rng.randint(1024, 65535),
    }
    if cls_name == "WorkerJobFinishedResponse":
        values["trace"] = _worker_trace(traces, rng, frames=3)
    if full:
        values |= {
            "trace": values.get("trace", trace),
            "job_id": f"job-{rng.randint(0, 9999):04d}",
            "tile": rng.randint(0, 3),
            "result": pm.FRAME_QUEUE_ITEM_FINISHED_ERRORED,
            "error_reason": f"seeded failure {rng.randint(0, 99)}",
            "metrics": _metrics_payload(registry_cls, rng),
            "received_at": rng.uniform(1.7e9, 1.8e9),
            "responded_at": rng.uniform(1.7e9, 1.8e9),
            "echo_request_time": rng.uniform(1.7e9, 1.8e9),
            "reason": "drain",
            "returned_frames": (5, 6, 7),
            "returned_tiles": (0, 3, None),
            "trace_id": rng.getrandbits(64),
            "span_events": {
                "process_name": "worker-0000abcd",
                "events": [{"name": "render", "ph": "X", "ts": 1.5, "dur": 2.0}],
                "dropped": 1,
            },
            "follower_id": "follower-1",
            "snapshot": {"units": [[1, None], [2, 3]]},
            "error": "seeded refusal",
        }
    else:
        values |= {
            "result": pm.FRAME_QUEUE_ITEM_FINISHED_OK,
            "epoch": rng.randint(1, 9),
        }
    cls = getattr(pm, cls_name)
    accepted = {field.name for field in dataclasses.fields(cls)}
    required = {
        field.name
        for field in dataclasses.fields(cls)
        if field.default is dataclasses.MISSING
        and field.default_factory is dataclasses.MISSING
    }
    if not full:
        # Bare: only what a reference-shaped peer sends.
        accepted = required
    return {name: value for name, value in values.items() if name in accepted}


def _pair(cls_name: str, *, full: bool, seed: int):
    ref = getattr(ref_pm, cls_name)(
        **_values(ref_pm, ref_models, ref_traces, RefRegistry, cls_name, full=full, seed=seed)
    )
    port = getattr(port_pm, cls_name)(
        **_values(port_pm, port_models, port_traces, PortRegistry, cls_name, full=full, seed=seed)
    )
    return ref, port


def test_every_message_class_is_ported():
    assert [cls.__name__ for cls in port_pm.ALL_MESSAGE_TYPES] == CLASS_NAMES
    for cls_name in CLASS_NAMES:
        assert getattr(port_pm, cls_name).type_name == getattr(ref_pm, cls_name).type_name


@pytest.mark.parametrize("full", [True, False], ids=["optional", "bare"])
@pytest.mark.parametrize("cls_name", CLASS_NAMES)
def test_message_bytes_equal_and_cross_decode(cls_name, full):
    seed = 1000 + CLASS_NAMES.index(cls_name)
    ref, port = _pair(cls_name, full=full, seed=seed)
    ref_text = ref_pm.encode_message(ref)
    port_text = port_pm.encode_message(port)
    assert port_text == ref_text
    assert port_pm.decode_message(ref_text) == port
    assert ref_pm.decode_message(port_text) == ref
    if full:
        # Every optional field this class has is set and on the wire (an
        # error reason rides inside the result object).
        payload = json.loads(port_text)["payload"]
        for field in dataclasses.fields(type(port)):
            if field.default is dataclasses.MISSING:
                continue
            if field.name == "error_reason":
                assert port.error_reason in json.dumps(payload["result"])
            else:
                assert field.name in payload


def test_worker_trace_round_trips_between_packages():
    ref_trace = _worker_trace(ref_traces, random.Random(7), frames=5)
    port_trace = _worker_trace(port_traces, random.Random(7), frames=5)
    assert json.dumps(port_trace.to_dict()) == json.dumps(ref_trace.to_dict())
    assert port_traces.WorkerTrace.from_dict(ref_trace.to_dict()) == port_trace
    assert ref_traces.WorkerTrace.from_dict(port_trace.to_dict()) == ref_trace


def test_protocol_version_equals_the_reference():
    assert port_pkg.PROTOCOL_VERSION == ref_pkg.PROTOCOL_VERSION
