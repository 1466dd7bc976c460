"""Multi-host decode: stream/GOP sharding across processes.

The reference's outermost parallel axis is independent decoder
instances (TestBenchMultipleInstance.c round-robin; storyDemo.html's
six players). A multi-host deployment puts that axis across processes
— each host decodes its own streams/GOPs with ZERO inner-loop
cross-host traffic — while a picture's MB-row bands ride the fast
intra-host links (NVLink on a GPU host; parallel/slices.py). The only
cross-host exchange is result collection (process_allgather), and the
per-picture collectives (band all_gather, deblock halo ppermute) stay
on the intra-host mesh.

Layout helpers here build the global (dp x sp) mesh with dp spanning
processes so the same shard_map pipeline runs unchanged whether dp is
intra-host (one process) or cross-host (jax.distributed).

Validated without a cluster by running N real OS processes with virtual
CPU devices (tests/test_multihost.py) — jax.distributed +
process_index are the same code path a multi-host GPU job uses.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int,
                   local_device_count: Optional[int] = None) -> None:
    """Initialize this process as one member of a multi-host decode
    job. coordinator_address/num_processes/process_id are always given
    explicitly (nothing here discovers a cluster). On the CPU
    validation path we pin the virtual device count and the gloo
    collectives backend BEFORE the first jax import side effects."""
    import os
    if local_device_count is not None:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        flags = os.environ.get("XLA_FLAGS", "")
        opt = f"--xla_force_host_platform_device_count={local_device_count}"
        if opt not in flags:
            os.environ["XLA_FLAGS"] = f"{flags} {opt}".strip()
    import jax
    # must not touch the backend before initialize(); decide the CPU
    # collectives impl from the environment instead of jax.devices()
    if os.environ.get("JAX_PLATFORMS", "").startswith("cpu") \
            or local_device_count is not None:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_dp_sp_mesh(n_sp: int = None):
    """Mesh over ALL processes' devices: dp spans hosts (process axis),
    sp spans each host's local devices (intra-host axis). n_sp
    defaults to the local device count."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    n_sp = n_sp or jax.local_device_count()
    n_dp = len(devs) // n_sp
    grid = np.array(devs).reshape(n_dp, n_sp)
    return Mesh(grid, ("dp", "sp"))


def decode_streams_multihost(datas: List[bytes],
                             backend: str = None,
                             sp_bands: int = 1) -> List[List[bytes]]:
    """Decode N streams sharded over processes: process p decodes the
    streams with index % num_processes == p on its local devices, then
    one process_allgather distributes every stream's output bytes
    to every host (the only cross-host traffic). Returns the full
    per-stream output list on every process. backend defaults to
    "device" on an accelerator platform and "cpu" otherwise.

    sp_bands > 1 routes each local decode through the process's LOCAL
    sp mesh (MB-row band sharding with intra-host collectives,
    parallel/slices.decode_stream_sliced) — the full dp-across-hosts x
    sp-within-host deployment shape (global_dp_sp_mesh) with dp
    realized as the process axis.  Streams whose slices don't align with the
    bands fall back to single-device per picture inside the sliced
    decoder."""
    import jax
    from jax.experimental import multihost_utils

    from ..core.decoder import Decoder

    np_, pid = jax.process_count(), jax.process_index()
    if backend is None:
        backend = "cpu" if jax.default_backend() == "cpu" else "device"

    sp_mesh = None
    if sp_bands > 1:
        from jax.sharding import Mesh
        local = jax.local_devices()
        assert len(local) >= sp_bands, (len(local), sp_bands)
        sp_mesh = Mesh(np.array(local[:sp_bands]), ("sp",))

    mine = {}
    sliced_cache = {}    # share jitted programs across local streams
    for i in range(pid, len(datas), np_):
        if sp_mesh is not None:
            from .slices import decode_stream_sliced
            mine[i] = decode_stream_sliced(datas[i], sp_mesh, sp_bands,
                                           decoder_cache=sliced_cache)
        else:
            d = Decoder(backend=backend)
            mine[i] = [o.frame.tobytes()
                       for o in d.decode_annexb(datas[i])]

    # cross-host result exchange: one fixed-size u8 tensor (padded),
    # allgathered once — the only cross-host traffic in the whole
    # decode. Header per stream: n_frames i32, then a PER-FRAME size
    # table (frames may change size mid-stream on a resolution
    # change), then the concatenated frame bytes.
    MAXF = 4096          # header slots; frames beyond this unsupported
    sizes = [sum(len(f) for f in fr) for fr in mine.values()] or [0]
    max_sz = int(multihost_utils.process_allgather(
        np.array([max(sizes)], np.int64)).max())
    hdr = 4 * (1 + MAXF)
    n = len(datas)
    local_buf = np.zeros((n, hdr + max_sz), np.uint8)
    for i, frames in mine.items():
        assert len(frames) <= MAXF, len(frames)
        blob = b"".join(frames)
        head = np.array([len(frames)] + [len(f) for f in frames],
                        np.int32)
        local_buf[i, :4 * len(head)] = np.frombuffer(head.tobytes(),
                                                     np.uint8)
        local_buf[i, hdr:hdr + len(blob)] = np.frombuffer(blob, np.uint8)
    gathered = multihost_utils.process_allgather(local_buf)  # [P,n,sz]
    out: List[List[bytes]] = []
    for i in range(n):
        row = gathered[i % np_, i]
        nf = int(np.frombuffer(row[:4].tobytes(), np.int32)[0])
        fsz = np.frombuffer(row[4:4 * (1 + nf)].tobytes(), np.int32)
        offs = np.concatenate([[0], np.cumsum(fsz)])
        blob = row[hdr:hdr + int(offs[-1])].tobytes()
        out.append([blob[offs[k]:offs[k + 1]] for k in range(nf)])
    return out
