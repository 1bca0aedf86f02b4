"""Joining the process group of a multi-process deployment.

Port of ``painlessinferenceacceleration_tpu/parallel/multihost.py``. The
JAX package joins ``jax.distributed`` and builds a (dcn, data, model)
device mesh; here every process is one rank of a
``torch.distributed`` group, and the mesh is a grid of ranks with one
process group per axis (``parallel/mesh.py``).

The environment contract is the JAX package's: ``PIA_COORDINATOR``
(host:port of rank 0's store), ``PIA_NUM_PROCESSES`` and
``PIA_PROCESS_ID``, and ``PIA_NUM_HOSTS`` (default 1) for the hosts the
ranks run on, host by host: host h runs ranks [h * per, (h + 1) * per),
per = ranks / hosts, and a rank's local index on its host picks its card.
The backend follows one rule, printed when the group is joined:
- NCCL where every rank has a CUDA device of its own: a host has at least
  as many cards as it runs ranks;
- gloo where the ranks run on the CPU, or share a CUDA device (NCCL
  refuses two ranks on one device).
Nothing falls back silently: a rank that cannot join raises.

The JAX package's ``host_local_batch_to_global`` has no counterpart: every
rank builds the same host batch and moves it to its own device itself.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch


def ranks_per_host(num_processes: int, num_hosts: Optional[int] = None) -> int:
    """The ranks each host runs (``num_hosts`` default ``PIA_NUM_HOSTS`` or
    1); the hosts must run the same number."""
    hosts = num_hosts or int(os.environ.get("PIA_NUM_HOSTS", "1"))
    if hosts < 1 or num_processes % hosts:
        raise ValueError(f"{num_processes} processes do not split over {hosts} hosts")
    return num_processes // hosts


def choose_backend(device: str, num_processes: int,
                   num_hosts: Optional[int] = None) -> Tuple[str, str]:
    """(backend, reason) for ``num_processes`` ranks over ``num_hosts``
    hosts (``ranks_per_host``) on ``device``'s type ("cpu" or "cuda"): the
    ranks of one host against that host's cards."""
    if device != "cuda":
        return "gloo", "the ranks run on the CPU"
    per = ranks_per_host(num_processes, num_hosts)
    n_cards = torch.cuda.device_count()
    if n_cards >= per:
        return "nccl", (f"each of the {per} ranks on a host has a CUDA device of its own "
                        f"({n_cards} on the host)")
    return "gloo", (f"{per} ranks on a host share {n_cards} CUDA device(s), and NCCL "
                    "refuses two ranks on one device")


def local_device(device: str, process_id: int, num_processes: Optional[int] = None,
                 num_hosts: Optional[int] = None) -> torch.device:
    """The rank's device: the CPU, or the card of its local index on its
    host (``process_id`` modulo ``ranks_per_host``; one host of every rank
    when ``num_processes`` is not given), modulo the host's cards, so ranks
    beyond the cards share them."""
    if device != "cuda":
        return torch.device("cpu")
    local = (process_id if num_processes is None
             else process_id % ranks_per_host(num_processes, num_hosts))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
    timeout_s: float = 600.0,
) -> str:
    """Join the ``torch.distributed`` process group and return its backend.

    The arguments fall back to ``PIA_COORDINATOR`` (host:port),
    ``PIA_NUM_PROCESSES`` and ``PIA_PROCESS_ID``; ``device`` ("cuda" unless
    the caller asks for "cpu") decides the backend by the rule above. A
    second call does nothing."""
    import datetime

    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_backend()
    coordinator_address = coordinator_address or os.environ.get("PIA_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("PIA_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("PIA_PROCESS_ID", "0"))
    if coordinator_address is None:
        if num_processes != 1:
            raise ValueError("initialize_multihost: no coordinator (PIA_COORDINATOR) for "
                             f"{num_processes} processes")
        coordinator_address = "localhost:0"
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} of {num_processes} processes")
    backend, why = choose_backend(device, num_processes)
    if backend == "nccl":
        torch.cuda.set_device(local_device(device, process_id, num_processes))
    print(f"initialize_multihost: rank {process_id} of {num_processes} over {backend} "
          f"({why}), coordinator {coordinator_address}", flush=True)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def make_multihost_mesh(tp: Optional[int] = None,
                        axes: Tuple[str, str, str] = ("dcn", "data", "model"),
                        hosts: Optional[int] = None):
    """A (dcn, data, model) rank grid over the joined group: ``tp`` ranks
    on the model axis (default: the ranks of one host, ``world // hosts``),
    one data group per host's remaining ranks, ``hosts`` (default
    ``PIA_NUM_HOSTS`` or 1) on dcn. The model axis never spans hosts."""
    import torch.distributed as dist

    from painlessinferenceacceleration_tpu_torch.parallel.mesh import make_mesh

    n = dist.get_world_size() if dist.is_initialized() else 1
    hosts = hosts or int(os.environ.get("PIA_NUM_HOSTS", "1"))
    per_host = ranks_per_host(n, hosts)
    tp = tp or per_host
    if n % tp or per_host % tp:
        raise ValueError(f"model axis {tp} does not divide {per_host} ranks a host")
    dp = per_host // tp
    return make_mesh((hosts, dp, tp), axes)
