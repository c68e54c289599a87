"""Device-mesh parallelism: tile bands, spp subsets and frame batches over
the cards of a worker and the processes of a multi-host group.

Port of ``tpu_render_cluster/parallel/``: one worker drives every card of
its host (``sharded_render.py``, a frame's inputs built once on the host,
the shards issued in turn from one thread) and, with
``mesh.initialize_multihost``, the cards of other hosts, its processes
exchanging their parts through ``torch.distributed`` (NCCL; gloo on the
CPU).
"""

from tpu_render_cluster_torch.parallel.mesh import device_mesh, local_device_count

__all__ = ["device_mesh", "local_device_count"]
