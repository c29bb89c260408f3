"""Checkpoint / resume — a capability the reference lacks entirely
(SURVEY.md section 5: output dir is wiped each run, no state save).

Large-domain runs make the naive formulation expensive: a ~64M-cell bf16
state is ~3.5 GB of f per buffer, and gathering + zipping it synchronously
inside the step loop stalls the device.  The writer therefore:

  - fetches device arrays to host in bounded x-slab chunks (axis 0 is
    contiguous in row-major order, so chunks stream straight into the
    .npy member payload without a host-side copy of the whole array);
  - streams the .npz (a zip of .npy members) incrementally — header first,
    then chunk payloads — so peak host memory is one chunk, not one state;
  - optionally (async_write=True, the runner's default) does the DISK write
    on a background thread: the device fetch completes synchronously (the
    buffers may be donated to the next jitted batch immediately after), the
    zip/write overlaps the next steps.  Files appear atomically
    (tmp + rename); a subsequent save or wait_pending() joins the writer.

Format is plain numpy .npz of {f, rho, vel} per level + the step counter,
dependency-free and unchanged across versions (format_version 1).
"""

from __future__ import annotations

import glob
import os
import threading
import zipfile
from typing import Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np


FORMAT_VERSION = 1

# fetch granularity: bound host memory and give the device-to-host transfer
# a pipelined shape (one slab in flight while the previous zips)
_CHUNK_BYTES = 256 * 2**20

_pending_lock = threading.Lock()
_pending: Optional[threading.Thread] = None


def _npy_header(shape, dtype) -> bytes:
    import io

    bio = io.BytesIO()
    np.lib.format.write_array_header_2_0(
        bio,
        {"descr": np.lib.format.dtype_to_descr(np.dtype(dtype)),
         "fortran_order": False, "shape": tuple(shape)},
    )
    return bio.getvalue()


def _fetch_chunks(arr):
    """Yield (shape, dtype, chunk-iterator) for a device (or host) array,
    splitting along axis 0 so each host-resident piece stays bounded."""
    shape = tuple(arr.shape)
    if arr.dtype == jnp.bfloat16:
        dtype = np.uint16  # npz can't serialize the ml_dtypes extension
    else:
        dtype = np.dtype(arr.dtype)
    itemsize = np.dtype(dtype).itemsize
    row_bytes = int(np.prod(shape[1:], dtype=np.int64)) * itemsize if shape \
        else itemsize
    step = max(1, _CHUNK_BYTES // max(row_bytes, 1)) if shape else 1

    def chunks():
        if not shape:
            a = np.asarray(arr)
            yield (a.view(np.uint16) if arr.dtype == jnp.bfloat16 else a)
            return
        for lo in range(0, shape[0], step):
            piece = np.asarray(arr[lo : lo + step])
            if arr.dtype == jnp.bfloat16:
                piece = piece.view(np.uint16)
            yield np.ascontiguousarray(piece)

    return shape, dtype, chunks


def wait_pending() -> None:
    """Block until the previous async checkpoint write (if any) is on disk."""
    global _pending
    with _pending_lock:
        th = _pending
    if th is not None:
        th.join()
    with _pending_lock:
        if _pending is th:
            _pending = None


def save_checkpoint(
    path_dir: str, step: int, states: List[Dict], async_write: bool = False
) -> str:
    """Save states to <path_dir>/ckpt_<step>.npz.  The device fetch is
    synchronous (buffers may be donated right after we return); with
    async_write the zip/disk write runs on a background thread and the file
    appears (atomically) when done."""
    os.makedirs(path_dir, exist_ok=True)
    path = os.path.join(path_dir, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp"

    # one previous writer at a time (also orders files for latest_checkpoint)
    wait_pending()

    # synchronous fetch phase: pull everything to host in bounded chunks
    members = [
        ("step.npy", [np.int64(step)]),
        ("n_levels.npy", [np.int64(len(states))]),
        ("format_version.npy", [np.int64(FORMAT_VERSION)]),
    ]
    for i, st in enumerate(states):
        for key, arr in st.items():
            if key.startswith("_"):
                continue  # derived carries (e.g. "_ifsl" endpoint slabs):
                # recomputed from f/rho/vel by coarse_step.seed_slabs on
                # resume, not physical state
            tag = "__bf16" if arr.dtype == jnp.bfloat16 else ""
            shape, dtype, chunks = _fetch_chunks(arr)
            members.append(
                (f"L{i}_{key}{tag}.npy", list(chunks()), shape, dtype)
            )

    def write():
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for m in members:
                name, pieces = m[0], m[1]
                with zf.open(name, "w", force_zip64=True) as fh:
                    if len(m) == 2:  # scalar member
                        np.lib.format.write_array(
                            fh, np.asanyarray(pieces[0])
                        )
                        continue
                    shape, dtype = m[2], m[3]
                    fh.write(_npy_header(shape, dtype))
                    for piece in pieces:
                        fh.write(piece.tobytes())
        os.replace(tmp, path)

    if async_write:
        global _pending
        th = threading.Thread(target=write, daemon=False,
                              name=f"ckpt-write-{step}")
        with _pending_lock:
            _pending = th
        th.start()
    else:
        write()
    return path


def latest_checkpoint(path_dir: str) -> Optional[str]:
    wait_pending()  # a file mid-write must not be invisible to resume
    files = sorted(glob.glob(os.path.join(path_dir, "ckpt_*.npz")))
    return files[-1] if files else None


def load_checkpoint(path: str, precision: Optional[str] = None) -> Tuple[int, List[Dict]]:
    """Load a checkpoint; with `precision` given, convert the saved f arrays
    to that storage precision (a run resumed after changing
    advanced.numerics.precision would otherwise feed the compiled step a
    mismatched dtype and fail at compile)."""
    from .ops import storage

    data = np.load(path)
    ver = int(data["format_version"]) if "format_version" in data else 0
    if ver > FORMAT_VERSION:
        raise ValueError(f"checkpoint format {ver} newer than supported")
    n = int(data["n_levels"])
    states = []
    for i in range(n):
        st = {}
        for key in ("f", "rho", "vel"):
            tagged = f"L{i}_{key}__bf16"
            if tagged in data:
                st[key] = jnp.asarray(data[tagged]).view(jnp.bfloat16)
            else:
                st[key] = jnp.asarray(data[f"L{i}_{key}"])
        if precision is not None:
            st["f"] = storage.encode_f(storage.decode_f(st["f"]), precision)
        states.append(st)
    return int(data["step"]), states
