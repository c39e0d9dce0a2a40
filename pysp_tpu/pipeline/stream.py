"""Streaming production driver: pipelined host decode -> device develop -> host save.

The reference is a library of single-shot calls with no batch driver (SURVEY.md §1 —
users loop in Python, each step blocking on the previous). For production serving the
three phases of a develop have disjoint resources — host CPU (raw decode + PNG/TIFF
encode), PCIe (transfers) and the accelerator (the develop program) — so a stream that
keeps all three busy hides nearly the whole host side behind device compute:

    decode[i+2] (thread pool) || develop[i+1] (device, async dispatch) || save[i] (thread)

JAX dispatch is asynchronous: ``develop(...)`` returns immediately with a future-like
Array, so the driver simply stays N files ahead on the decode side and hands finished
device buffers to a writer pool. Files with different sensor shapes recompile once per
shape (XLA program cache) — sort inputs by shape for best behavior.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .develop import DevelopConfig, develop

__all__ = ["develop_stream", "develop_files"]


def develop_stream(
    sources: Sequence,
    cfg: DevelopConfig = DevelopConfig(),
    decode_workers: int = 4,
    prefetch: int = 2,
    loader: Optional[Callable] = None,
):
    """Yield (source, developed sRGB ndarray) pairs with decode/compute overlap.

    ``loader`` defaults to pysp_tpu.load_raw; ``prefetch`` bounds how many decoded
    frames may wait on the host (memory bound: one 24 MP frame is ~96 MB).
    """
    import jax

    if loader is None:
        from ..io.raw_loader import load_raw as loader  # type: ignore

    sources = list(sources)
    if not sources:
        return

    with ThreadPoolExecutor(max_workers=decode_workers) as pool:
        pending: List[Tuple[object, object]] = []  # (source, decode future)
        in_flight: List[Tuple[object, object]] = []  # (source, device array)
        idx = 0

        def fill():
            nonlocal idx
            while idx < len(sources) and len(pending) < decode_workers + prefetch:
                pending.append((sources[idx], pool.submit(loader, sources[idx])))
                idx += 1

        fill()
        while pending or in_flight:
            # launch device work for every decoded frame, up to the prefetch bound
            while pending and len(in_flight) <= prefetch:
                src, fut = pending.pop(0)
                frame = jax.device_put(fut.result())
                in_flight.append((src, develop(frame, cfg)))
                fill()
            src, dev = in_flight.pop(0)
            yield src, np.asarray(dev)  # materialize: waits for the device
            fill()


def develop_files(
    paths: Sequence[str],
    out_dir: str,
    cfg: DevelopConfig = DevelopConfig(),
    ext: str = ".png",
    decode_workers: int = 4,
    save_workers: int = 2,
) -> List[str]:
    """Develop many raw files into ``out_dir`` with decode/compute/save overlap.

    Returns the written paths (input order preserved).
    """
    from ..io.image_out import save_image

    os.makedirs(out_dir, exist_ok=True)
    written: List[str] = []
    with ThreadPoolExecutor(max_workers=save_workers) as savers:
        saves = []
        for src, srgb in develop_stream(paths, cfg, decode_workers=decode_workers):
            dst = os.path.join(
                out_dir, os.path.splitext(os.path.basename(str(src)))[0] + ext
            )
            saves.append(savers.submit(save_image, dst, srgb))
            written.append(dst)
        for s in saves:
            s.result()
    return written
