#!/usr/bin/env python3
"""Measure the layout model's constants on the card and write them as JSON
for ``sddmm_tpu_torch.reorder.autotune.load_calibration``: the counterpart
of scripts/calibrate.py, importing nothing of JAX.

The port's layout model ships the JAX package's constants, measured on a
TPU.  Measure the card's and rank with them:

    python scripts/torch_calibrate.py      # -> sddmm_tpu_torch/calibration_h100.json
    SDDMM_TPU_CALIBRATION=sddmm_tpu_torch/calibration_h100.json \\
        python -m sddmm_tpu_torch.bench --retune

The file has the JAX script's keys, in its units, so either package's
loader reads the other's file, plus ``card`` (``nvidia-smi``'s name and
power limit, or "cpu").  Probes, each on data made from a seed on
``--device`` (the card unless ``--device cpu``; without a card the default
raises):

- ``stream_gbps``: ``torch.sum`` of a 512 MiB fp32 tensor, read bytes only
  (the JAX probe's read-reduce).  This is not the bench's ``stream_gbps``,
  a device-to-device copy that counts the bytes read and written.
- ``row_rate_8mb``: M rows/s of ``torch.index_select`` of 2 M random row
  indices into a new tensor (``jnp.take``'s work) from an about 8 MB
  source, at 128, 256, 512, 1024 and 2048 B a row.
- ``src_factor``: the 512 B rate at other source footprints over the 8 MB
  rate: the JAX script's 2, 4, 16 and 32 MB, and 64, 128 and 256 MB, past
  the card's 50 MB L2.
- ``dot_g16_ms``: M 16-row groups/s of the tile kernel (``tile_table``,
  ``csrc/tile_dot.cu``) over ``2048 / (m / 16)`` tiles of (m, 128) x
  (128, 128) at m = 16, 32, 64 and 128, in every compute mode, the
  operands in the mode's storage dtypes; the identity work table is built
  once a probe, so only launches are timed.  On the card every timed call
  must launch the mode's kernel instance (its launch count is checked); on
  the CPU the probe runs the kernel's plain version.

Timing: on the card the median of sessions of ``utils.timing.
queued_time_ms``, CUDA events around calls queued behind a held stream (the
device's time, as the JAX script's loop differencing gives the TPU's:
events around each call would read the dot probe's Python wrapper, which
takes longer than its kernel); on the CPU ``session_median_ms``'s host
clock, where the numbers only test the mechanics.
``--quick`` shrinks every probe 64-fold and times fewer calls (its numbers
mean nothing).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

DEFAULT_OUTPUT = ROOT / "sddmm_tpu_torch" / "calibration_h100.json"
STREAM_BYTES = 512 * 1024 * 1024
GATHER_SRC_BYTES = 8 * 1024 * 1024
GATHER_INDICES = 2_000_000
ROW_BYTES = (128, 256, 512, 1024, 2048)
#: source footprints (MB) of ``src_factor``: the JAX script's, then past L2
SRC_MB = (2, 4, 16, 32, 64, 128, 256)
DOT_HEIGHTS = (16, 32, 64, 128)
DOT_TILES = 2048   # 16-row tiles of the dot probe; fewer as tiles grow
DOT_K = 128
DOT_LANES = 128
QUICK_SCALE = 64
#: warm-up calls of each timed session (``utils.timing.call_times_ms``)
WARMUP = 3
DOT_REPEATS = 5
GATHER_REPEATS = 4


def iterations_of(quick: bool, iterations) -> tuple:
    """(timed calls of a dot session, dot sessions, timed calls of a stream
    or gather session): the JAX script's split at full size; ``--quick``
    times 3 calls in 2 sessions a dot probe (the plain version on the CPU
    takes milliseconds a call)."""
    if quick:
        dot = iterations or 3
        return dot, 2, max(dot // 10, 5)
    dot = iterations or 200
    return dot, DOT_REPEATS, max(dot // 10, 5)


def dot_calls(quick: bool = False, iterations=None) -> int:
    """Timed and warm-up calls of one dot probe: the tile kernel's launches
    it adds on the card, at least (a session whose stream hold the host
    outran times its calls again)."""
    dot, sessions, _ = iterations_of(quick, iterations)
    return sessions * (dot + WARMUP)


def _rate(x: float) -> float:
    """A rate rounded to 5 significant digits (a CPU's dot rate is far
    below the 0.1 M groups/s the JAX script rounds to)."""
    return float(f"{x:.5g}")


def _time(fn, dev, iterations, repeats):
    """ms per call: on the card the median of ``repeats`` sessions of
    ``queued_time_ms`` (the device's work alone: the dot probe's Python
    wrapper takes longer than its 2048 groups), on the CPU of host-clock
    sessions."""
    import statistics

    import torch
    from sddmm_tpu_torch.utils.timing import queued_time_ms, \
        session_median_ms
    if dev.type != "cuda":
        return session_median_ms(fn, dev, iterations, repeats)
    with torch.cuda.device(dev):
        return statistics.median(queued_time_ms(fn, iterations, WARMUP)
                                 for _ in range(repeats))


def probe_stream(dev, gen, scale, iters) -> float:
    """GB/s of a read-reduce of a fp32 tensor (read bytes only)."""
    import torch
    n_el = STREAM_BYTES // 4 // scale
    big = torch.rand(n_el, generator=gen, device=dev)
    ms = _time(lambda: torch.sum(big), dev, iters, GATHER_REPEATS)
    return _rate(n_el * 4 / (ms * 1e6))


def probe_gather(dev, gen, row_bytes, src_bytes, n_idx, iters) -> float:
    """M rows/s of ``index_select`` of ``n_idx`` random rows of
    ``row_bytes`` from a source of about ``src_bytes``."""
    import torch
    rows = max(src_bytes // row_bytes, 16)
    src = torch.rand((rows, row_bytes // 4), generator=gen, device=dev)
    idx = torch.randint(0, rows, (n_idx,), generator=gen, device=dev)
    ms = _time(lambda: torch.index_select(src, 0, idx), dev, iters,
               GATHER_REPEATS)
    return n_idx / ms / 1e3


def probe_dot(dev, gen, mode, m, scale, iters, sessions) -> float:
    """M 16-row groups/s of the tile kernel's ``mode`` instance over a
    batch of (m, 128) x (128, 128) tiles; on the card, raises unless every
    call launched the kernel."""
    import torch
    from sddmm_tpu_torch import _kernels
    from sddmm_tpu_torch.ops.tile_dot import STORAGE, identity_table, \
        tile_table
    nb = max((DOT_TILES // (m // 16)) // scale, 8)
    adt, bdt = STORAGE[mode]
    a = torch.rand((1, nb * m, DOT_K), generator=gen,
                   device=dev).to(adt)
    b = torch.rand((1, 1, nb * DOT_LANES, DOT_K), generator=gen,
                   device=dev).to(bdt)
    out = torch.empty((1, nb * m * DOT_LANES), dtype=torch.float32,
                      device=dev)
    table = identity_table(nb, m, DOT_LANES, m, DOT_LANES, m * DOT_LANES,
                           DOT_LANES, dev)
    name = f"sddmm_tile_dot_{mode}"
    calls = 0

    def call():
        nonlocal calls
        calls += 1
        tile_table(a, b, table, mode, out)

    before = _kernels.launches[name]
    ms = _time(call, dev, iters, sessions)
    moved = _kernels.launches[name] - before
    if dev.type == "cuda" and moved != calls:
        raise RuntimeError(f"dot probe {mode},{m}: {calls} calls launched "
                           f"{name} {moved} times")
    return nb * (m // 16) / ms / 1e3


def calibrate(device="cuda", quick: bool = False, iterations=None) -> dict:
    """The calibration of ``device``: the JSON object the script writes."""
    import torch
    from sddmm_tpu_torch.bench import card_label
    from sddmm_tpu_torch.ops.hybrid import check_device
    from sddmm_tpu_torch.ops.tile_dot import MODES
    from sddmm_tpu_torch.utils.logger import device_name

    dev = check_device(device)
    if dev.type == "cuda":
        from sddmm_tpu_torch import _kernels
        _kernels.load()     # a failed build raises here
    scale = QUICK_SCALE if quick else 1
    dot_iters, dot_sessions, iters = iterations_of(quick, iterations)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {"device": device_name(dev),
           "platform": "gpu" if dev.type == "cuda" else "cpu",
           "card": card_label(dev)}

    out["stream_gbps"] = probe_stream(dev, gen, scale, iters)

    src_bytes, n_idx = GATHER_SRC_BYTES // scale, GATHER_INDICES // scale
    row_rate = {}
    for rb in ROW_BYTES:
        row_rate[str(rb)] = _rate(
            probe_gather(dev, gen, rb, src_bytes, n_idx, iters))
    out["row_rate_8mb"] = row_rate

    base = row_rate["512"]
    factors = {}
    for mb in SRC_MB:
        rate = probe_gather(dev, gen, 512, mb * 1024 * 1024 // scale, n_idx,
                            iters)
        factors[str(mb)] = round(rate / max(base, 1e-9), 3)
    out["src_factor"] = factors

    dot = {}
    for mode in MODES:
        for m in DOT_HEIGHTS:
            dot[f"{mode},{m}"] = _rate(
                probe_dot(dev, gen, mode, m, scale, dot_iters,
                          dot_sessions))
    out["dot_g16_ms"] = dot
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Measure the layout model's constants on the card.")
    p.add_argument("-o", "--output", default=str(DEFAULT_OUTPUT))
    p.add_argument("--quick", action="store_true",
                   help="sizes 64x smaller (a mechanics test: the numbers "
                   "are not meaningful)")
    p.add_argument("--iterations", type=int, default=None,
                   help="timed calls of a dot session (default 200, 3 with "
                   "--quick); the stream and gathers take a tenth, at "
                   "least 5")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' only when asked for")
    args = p.parse_args(argv)

    out = calibrate(args.device, args.quick, args.iterations)
    dest = Path(args.output)
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
