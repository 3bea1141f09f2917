#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA GPU and check every result.

    python3 chip_smoke.py                 # RMAT scale 20, edge factor 16
    python3 chip_smoke.py --scale 14      # a quicker rehearsal of the graph path

Phases, in order; any failure raises and the script exits nonzero:

1. the card's name and power limit (``nvidia-smi``);
2. build the four CUDA kernels from ``src/repro_torch/kernels/csrc``
   (``segment_rf``, ``edge_spmv``, ``flash_attention``, ``decode_attention``),
   one ``nvcc`` per source, all started together; print each ``ptxas`` report;
   check with ``cuobjdump -sass`` that every bf16 (tensor-core) flash
   instantiation issues HGMMA;
3. RMAT graph and GEO order on the host;
4. kernel parity, each kernel against its plain PyTorch version on the card:
   ``segment_rf`` exactly, at the main path's row shapes and at edge cases
   (rows not a multiple of 8, widths not a multiple of the tile, all-PAD
   rows, single-id rows, W = 1, a row wider than 65535 tiles);
   ``edge_spmv`` at rtol/atol 1e-5 (atomics sum in a varying order) at the
   JAX tests' shapes, C = 1, W_E = 1, all-padding rows, ids past W_V, a hub
   row (one dst in every slot: one run across warps and blocks), alternating
   dst, sorted dst at an odd W_E, and more chunks than the grid has blocks,
   so that blocks stride over them;
   ``flash_attention`` at the JAX tests' cases in f32 (2e-5, the CUDA-core
   kernel) and bf16 (one bf16 rounding step: 2^-7·|plain| + 1e-4, the
   tensor-core kernel), non-causal, D = 256 with window and softcap, ragged
   S at D 128 and 256, and D = 96 (phi-3-vision's head_dim, zero-padded to
   128 by the wrapper) causal and windowed with softcap; ``decode_attention``
   at the JAX tests' cases, a ``cache_len = 0`` row, softcap, a bf16 cache and
   a bf16 cache at D = 96 (1e-4, f32 outputs), each case through both entry
   points: the per-tile partials and the merged path (split kernel, then
   combine kernel), the latter also at ``cache_len`` 0, 1 and either side of
   a split boundary, at Gq 1 and 8, and with a bf16 query;
5. slice 1, the graph path, with every launch count set to 0 just before it:
   CEP packs at k = 4, 8, 16, 64, 128 (RF and mirrors measured on the card,
   equal to the numpy oracle), rescale 16→17 and 8→12→8 with the
   from-scratch byte check, re-checked RF equal to the oracle, PageRank /
   SSSP / WCC on the packs at k = 17 and k = 4; ``segment_rf`` must launch
   once per pack and re-checked rescale, and no other kernel;
6. slice 2, the entry points of the other three kernels, with every launch
   count set to 0 just before it: ``ops.chunked_spmv`` on the GEO-ordered
   edge list with weights 1/deg[src] and the k = 4 PageRank vector as x —
   (a) 16 chunks with full windows, (b) 128 chunks with full windows,
   (c) 16 chunks with 65,536-wide windows (|V|/16) and an out-of-window pass — each
   held against a float64 numpy oracle at rtol 1e-4, with the chunks packed
   on the card (``ops.pack_windows_device``); ``ops.flash_attention``
   at qwen3-8b width (32 heads, 8 KV heads repeated, S 8192, D 128, bf16,
   causal) and at gemma2-9b local-layer width (16 heads, D 256, window 4096,
   softcap 50); ``ops.decode_attention`` at qwen3-8b width (batch 8:
   64 cache rows of 32,768 bf16 positions, Gq 4, D 128); each attention
   result held against the plain version on the card (flash one group of
   heads at a time, to bound its memory; SDPA's ratio to the same limit at
   qwen3-8b width is printed as a reading); ``edge_spmv`` must launch 3
   times, ``flash_attention`` 2, both on its tensor-core kernel
   (``tc_launches``), and ``decode_attention`` once: its split kernel
   (``launches``) and its combine kernel (``merge_launches``) once each;
   then, for each
   ``chunked_spmv`` call, the device packing must be byte-equal to the numpy
   ``pack_windows`` at full size, and the call is timed again, whole and in
   phases (H2D and range check, packing, x windows, kernel, add-back,
   out-of-window pass), with a synchronize after each phase;
7. each kernel's time (CUDA events) beside its bound, the plain version's
   time and, where one PyTorch call computes the same function, that call's
   time, at the paths' full-size shapes. A bound counts the bytes the
   function must move from this run's inputs (for ``edge_spmv``: its three
   edge arrays, its output, and of x only the distinct entries each chunk
   gathers) and, for flash, the operations of the key positions the masks
   leave; ``edge_spmv`` also reports its share of that bound. Decode is timed
   as the merged call (both kernels) and as the partials entry point, beside
   SDPA in two forms (3-D with a float mask, 4-D with a boolean mask; the
   faster is the library time), with the bytes the split kernel reads and
   the rate it reaches.

Output: phase lines, then the card line, one ``{"kernels": [...]}`` JSON line
and, last, ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repository's ``src/`` beside this file, it exits nonzero and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12  # HBM3 rate of an H100 SXM (NVIDIA data sheet)
H100_FP32_OPS_PER_S = 67e12  # non-tensor-core f32 rate; the kernel's int compares run on the same ALUs
H100_BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core rate
KERNELS = ("segment_rf", "edge_spmv", "flash_attention", "decode_attention")
PACK_KS = (4, 16, 64, 128)
ROW_KS = (4, 8, 12, 16, 17, 64, 128)  # every k whose rows the main path counts
PAGERANK_RTOL = 1e-4  # CUDA scatter-add uses atomics: f32 sums in varying order
# f32 sums in varying order (atomics): against a float64 oracle, and kernel
# against plain version at full size, where a hub vertex sums thousands of terms
SPMV_RTOL = 1e-4
SPMV_PARITY_TOL = 1e-5  # kernel against plain version at the small parity shapes
F32_TOL, DECODE_TOL = 2e-5, 1e-4
# A bf16 flash output: the kernel and the plain version each round an f32 sum
# to bf16 (8 significant bits), so they may differ by one rounding step, at
# most 2^-7 of the value, plus slack for outputs near zero.
BF16_RTOL, BF16_ATOL = 2**-7, 1e-4
# Model widths: src/repro/configs/qwen3_8b.py and gemma2_9b.py.
QWEN3 = dict(heads=32, kv_heads=8, head_dim=128)
GEMMA2 = dict(heads=16, kv_heads=8, head_dim=256, window=4096, softcap=50.0)
PREFILL_SEQ = 8192
DECODE_BATCH, DECODE_CACHE, DECODE_BLOCK = 8, 32768, 512
FLASH_HEAD_GROUP = 8  # heads per call of the dense plain version (its logits: 8 x S^2 f32)


def decode_cache_lengths(rows: int) -> np.ndarray:
    """``cache_len`` of the full-size decode call: numpy seed 0 in [1, S],
    with one full row and one not a multiple of 512."""
    cache_np = np.random.default_rng(0).integers(1, DECODE_CACHE + 1, size=rows).astype(np.int32)
    cache_np[0], cache_np[1] = DECODE_CACHE, DECODE_CACHE // 2 + 123
    return cache_np


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def close(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float, what: str) -> float:
    """Assert |got - want| <= atol + rtol·|want| element by element; return
    the max abs difference."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=lambda m: f"{what}: {m}")
    return err


def tol_ratio(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    """max |got - want| / (atol + rtol·|want|): at most 1 where ``close`` passes."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def rel_close(got: torch.Tensor, want: torch.Tensor, rtol: float, what: str) -> float:
    """Assert |got - want| <= rtol·|want| element by element (exact zeros stay
    zero); return the max relative difference."""
    diff = (got.double() - want.double()).abs()
    bad = int((diff > rtol * want.double().abs()).sum())
    rel = float((diff / want.double().abs()).nan_to_num(0.0, posinf=np.inf).max())
    check(bad == 0, f"{what}: {bad} elements differ by more than rtol {rtol} (max rel {rel:.3e})")
    return rel


def sorted_rows(rng: np.random.Generator, c: int, w: int, pad_id: int) -> np.ndarray:
    """(c, w) int32 rows, ascending with repeats, each padded at a random tail."""
    rows = np.cumsum(rng.integers(0, 3, size=(c, w), dtype=np.int8), axis=1, dtype=np.int32)
    n_valid = rng.integers(0, w + 1, size=c)
    rows[np.arange(w)[None, :] >= n_valid[:, None]] = pad_id
    return rows


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def synced_s(fn):
    """``fn()`` and its seconds on the host clock, with the card idle before
    and after: ``(result, seconds)``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def prefill_inputs(gen: torch.Generator, dev) -> list:
    """bf16 q, k, v and the keywords of the two full-size prefill calls:
    qwen3-8b (causal) and gemma2-9b local layer (window, softcap). K and V
    are made at the model's KV heads and repeated to its query heads, as the
    JAX callers do before they call the kernel."""
    calls = []
    for cfg, kw in ((QWEN3, dict(causal=True)),
                    (GEMMA2, dict(causal=True, window=GEMMA2["window"], softcap=GEMMA2["softcap"]))):
        heads, kv_heads, hd = cfg["heads"], cfg["kv_heads"], cfg["head_dim"]
        qkv = [torch.randn((1, kv_heads if i else heads, PREFILL_SEQ, hd), generator=gen, device=dev,
                           dtype=torch.bfloat16) for i in range(3)]
        qkv[1:] = [t.repeat_interleave(heads // kv_heads, dim=1) for t in qkv[1:]]
        calls.append((qkv, kw))
    return calls


def flash_plain(plain, qkv: list, kw: dict) -> torch.Tensor:
    """The dense plain version ``plain`` over FLASH_HEAD_GROUP heads a call,
    to bound the memory of its logits."""
    return torch.cat([plain(*(t[:, h0:h0 + FLASH_HEAD_GROUP] for t in qkv), **kw)
                      for h0 in range(0, qkv[0].shape[1], FLASH_HEAD_GROUP)], dim=1)


def visible_pairs(s: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs that the masks leave visible in one head."""
    q = np.arange(s, dtype=np.int64)
    hi = q + 1 if causal else np.full(s, s)
    lo = np.maximum(q - window + 1, 0) if window is not None else np.zeros(s, dtype=np.int64)
    return int((hi - lo).sum())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=20, help="RMAT scale: 2**scale vertices")
    ap.add_argument("--edge-factor", type=int, default=16, help="RMAT edges sampled per vertex")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.compat import PAD_ID
    from repro_torch.core import cep, metrics, ordering
    from repro_torch.core.graph import rmat_graph
    from repro_torch.elastic.rescale_exec import EDGE_BYTES, ElasticRescaler
    from repro_torch.graphs import engine as E
    from repro_torch.kernels import _build, edge_spmv, ops, segment_rf
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import segment_distinct_counts_ref

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 products stay f32
    torch.backends.cudnn.allow_tf32 = False
    modules = {"segment_rf": segment_rf, "edge_spmv": edge_spmv, "flash_attention": fa, "decode_attention": dec}

    def reset_launches() -> None:
        for m in modules.values():
            m.launches = 0
        fa.tc_launches = 0
        dec.merge_launches = 0

    def read_launches() -> dict:
        return {name: m.launches for name, m in modules.items()}

    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    phases: dict = {}
    report = {name: {"max_abs_err": 0.0} for name in KERNELS}

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    lib_paths = _build.build_all(KERNELS)
    for name in KERNELS:
        _build.load(name)
    phases["build_s"] = time.perf_counter() - t0
    log(f"build: {', '.join(p.name for p in lib_paths)} in {phases['build_s']:.3f} s")
    for p in lib_paths:
        build_log = p.with_name(p.name + ".log")
        if build_log.exists():  # written by the build that made the library
            log(build_log.read_text().strip())
    # The bf16 flash kernel must run on the tensor cores: HGMMA in its SASS.
    cuobjdump = pathlib.Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_paths[KERNELS.index("flash_attention")])],
                          capture_output=True, text=True, check=True).stdout
    hgmma = {f.split()[0]: f.count("HGMMA") for f in sass.split("Function : ")[1:] if "flash_tc_kernel" in f.split()[0]}
    check(len(hgmma) == len(fa.HEAD_DIMS) and all(hgmma.values()),
          f"flash_attention: every tensor-core instantiation must issue HGMMA, got {hgmma}")
    log(f"flash_attention SASS: HGMMA instructions per tensor-core instantiation {sorted(hgmma.values())}")

    # ------------------------------------------------------- graph + order
    t0 = time.perf_counter()
    g = rmat_graph(scale=args.scale, edge_factor=args.edge_factor, seed=0)
    phases["rmat_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    order = ordering.geo_order(g, k_min=4, k_max=128)
    phases["geo_order_s"] = time.perf_counter() - t0
    src, dst = g.src[order], g.dst[order]
    n, v = g.num_edges, g.num_vertices
    log(f"graph: |V|={v} |E|={n} rmat {phases['rmat_s']:.3f} s, geo_order {phases['geo_order_s']:.3f} s")

    # ------------------------------------------------ kernel parity: segment_rf
    rng = np.random.default_rng(0)
    cases = [(k, 2 * int(np.diff(cep.chunk_bounds(n, k)).max())) for k in ROW_KS]
    cases += [(13, 1000), (9, 4097), (3, 3 * 4096 + 1), (5, 1), (1, 65535 * 4096 + 4097)]
    t0 = time.perf_counter()
    for c, w in cases:
        rows = sorted_rows(rng, c, w, PAD_ID)
        if (c, w) == (13, 1000):
            rows[0] = PAD_ID  # an all-PAD row
            rows[1] = 7  # a single distinct id, no padding
            rows[2, :500], rows[2, 500:] = 7, PAD_ID  # a single id, then padding
        t = torch.from_numpy(rows).to(dev)
        got = segment_rf.segment_distinct_counts(t)
        want = segment_rf.segment_distinct_counts_torch(t)
        torch.cuda.synchronize()
        report["segment_rf"]["max_abs_err"] = max(report["segment_rf"]["max_abs_err"],
                                                  int((got.long() - want.long()).abs().max()))
        check(torch.equal(got, want), f"segment_rf parity failed at (C, W) = ({c}, {w})")
        if c * w <= 1 << 16:
            check(np.array_equal(got.cpu().numpy(), segment_distinct_counts_ref(rows, PAD_ID)),
                  f"segment_rf differs from the numpy oracle at ({c}, {w})")
        log(f"parity segment_rf (C, W) = ({c}, {w}): exact")
        del t, got, want
    all_pad = torch.full((8, 5000), PAD_ID, dtype=torch.int32, device=dev)
    check(int(segment_rf.segment_distinct_counts(all_pad).abs().sum()) == 0, "all-PAD rows must count 0")

    # ------------------------------------------------- kernel parity: edge_spmv
    # dst layouts: "random", "hub" (one dst in every slot), "alternating" (no
    # two neighbours share a dst), "sorted" (long runs, as GEO order makes).
    for c, we, wv, lo, hi, layout in [
            (2, 16, 32, 0, 33, "random"), (5, 64, 128, 0, 129, "random"), (3, 128, 256, 0, 257, "random"),
            (1, 1, 8, 0, 8, "random"), (1, 300, 64, 64, 100, "random"), (4, 5000, 512, -3, 600, "random"),
            (3, 5_001, 512, 0, 512, "hub"), (2, 9_999, 512, 0, 512, "alternating"),
            (5, 40_001, 4096, -1, 4097, "sorted"), (700, 6_001, 1024, 0, 1025, "sorted"),
            (70_000, 3, 8, 0, 9, "sorted")]:
        src_ids = rng.integers(lo, hi, size=(c, we)).astype(np.int32)
        dst_ids = {"random": lambda: rng.integers(lo, hi, size=(c, we)),
                   "hub": lambda: np.full((c, we), 7),
                   "alternating": lambda: np.broadcast_to(np.arange(we) % 2 * 5 + 3, (c, we)),
                   "sorted": lambda: np.sort(rng.integers(lo, hi, size=(c, we)), axis=1)}[layout]()
        ids = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev) for a in (src_ids, dst_ids)]
        w_t = torch.from_numpy(rng.standard_normal((c, we)).astype(np.float32)).to(dev)
        x_t = torch.from_numpy(rng.standard_normal((c, wv)).astype(np.float32)).to(dev)
        got = edge_spmv.spmv_blocked(*ids, w_t, x_t)
        what = f"(C, W_E, W_V) = ({c}, {we}, {wv}), ids in [{lo}, {hi}), {layout} dst"
        err = close(got, edge_spmv.spmv_blocked_torch(*ids, w_t, x_t), SPMV_PARITY_TOL, SPMV_PARITY_TOL,
                    f"edge_spmv parity at {what}")
        if lo >= wv:
            check(not bool(got.any()), "edge_spmv: all-padding rows must add exactly 0")
        report["edge_spmv"]["max_abs_err"] = max(report["edge_spmv"]["max_abs_err"], err)
        log(f"parity edge_spmv {what}: max abs err {err:.3e}")

    # ------------------------------------------- kernel parity: flash attention
    gen = torch.Generator(device=dev).manual_seed(0)
    flash_cases = [(1, 2, 128, 64, None, None, True), (2, 1, 256, 32, None, None, True),
                   (1, 2, 256, 64, 128, None, True), (1, 1, 128, 64, None, 30.0, True),
                   (2, 2, 384, 128, 256, 50.0, True), (1, 1, 128, 32, None, None, False),
                   (1, 2, 512, 256, 256, 50.0, True), (1, 2, 1000, 128, None, None, True),
                   (1, 1, 777, 256, 300, 50.0, True),
                   (1, 2, 512, 96, None, None, True), (1, 2, 700, 96, 200, 50.0, True)]  # D = 96: padded to 128
    for b, h, s, d, window, softcap, causal in flash_cases:
        for dtype, rtol, atol in ((torch.float32, F32_TOL, F32_TOL), (torch.bfloat16, BF16_RTOL, BF16_ATOL)):
            q, k, vv = (torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype) for _ in range(3))
            kw = dict(causal=causal, window=window, softcap=softcap)
            tc_before = fa.tc_launches
            got = fa.flash_attention(q, k, vv, **kw)
            check(got.dtype == dtype and got.shape == q.shape, "flash_attention: wrong output type or shape")
            check(fa.tc_launches == tc_before + (dtype == torch.bfloat16),
                  "flash_attention: bf16 must run the tensor-core kernel and f32 the CUDA-core kernel")
            err = close(got, fa.flash_attention_torch(q, k, vv, **kw), rtol, atol,
                        f"flash_attention parity at {(b, h, s, d)} {dtype} {kw}")
            report["flash_attention"]["max_abs_err"] = max(report["flash_attention"]["max_abs_err"], err)
            log(f"parity flash_attention (B, H, S, D) = {(b, h, s, d)} {str(dtype)[6:]} {kw}: max abs err {err:.3e}")

    # ------------------------------------------ kernel parity: decode attention
    decode_cases = [(2, 4, 512, 64, 128, None, torch.float32, None), (1, 1, 1024, 32, 256, None, torch.float32, None),
                    (3, 8, 256, 128, 256, None, torch.float32, None),
                    (3, 4, 512, 64, 128, None, torch.float32, [0, 200, 512]),
                    (2, 4, 512, 128, 128, 20.0, torch.float32, None),
                    (4, 4, 2048, 128, 512, None, torch.bfloat16, [1, 700, 1536, 2048]),
                    (4, 4, 2048, 96, 512, None, torch.bfloat16, [1, 700, 1536, 2048])]  # D = 96: padded to 128
    for bh, gq, s, d, block_s, softcap, kv_dtype, cache in decode_cases:
        q = torch.randn((bh, gq, d), generator=gen, device=dev)
        k, vv = (torch.randn((bh, s, d), generator=gen, device=dev).to(kv_dtype) for _ in range(2))
        cl = (torch.randint(1, s + 1, (bh,), generator=gen, device=dev, dtype=torch.int32) if cache is None
              else torch.tensor(cache, dtype=torch.int32, device=dev))
        got = dec.decode_attention_partials(q, k, vv, cl, block_s=block_s, softcap=softcap)
        want = dec.decode_attention_partials_torch(q, k, vv, cl, scale=d**-0.5, block_s=block_s, softcap=softcap)
        what = f"decode_attention parity at {(bh, gq, s, d, block_s)} softcap {softcap} {kv_dtype} cache_len {cache}"
        err = max(close(gv, wv_, DECODE_TOL, DECODE_TOL, f"{what} ({name})") for name, gv, wv_ in zip("oml", got, want))
        err = max(err, close(dec.merge_partials(*got)[0], dec.merge_partials(*want)[0], DECODE_TOL, DECODE_TOL, what))
        merged = dec.decode_attention(q, k, vv, cl, block_s=block_s, softcap=softcap)
        err = max(err, close(merged, dec.merge_partials(*want)[0], DECODE_TOL, DECODE_TOL, f"{what} (merged)"))
        if cache is not None and cache[0] == 0:
            mean_v = vv[0].float().mean(0).expand(gq, d)
            for name, out in (("partials", dec.merge_partials(*got)[0]), ("merged", merged)):
                close(out[0], mean_v, DECODE_TOL, DECODE_TOL, f"cache_len = 0 must decode to the mean of v ({name})")
        report["decode_attention"]["max_abs_err"] = max(report["decode_attention"]["max_abs_err"], err)
        log(f"parity decode_attention (BH, Gq, S, D, block_s) = {(bh, gq, s, d, block_s)} softcap {softcap} "
            f"{str(kv_dtype)[6:]} cache_len {cache or 'random'}: max abs err {err:.3e} (partials and merged)")
    # The merged path at split boundaries, an empty row, Gq 1 and 8, a bf16 query.
    sp = dec.SPLIT
    for gq, d, kv_dtype, q_dtype in [(4, 128, torch.bfloat16, torch.bfloat16), (8, 128, torch.float32, torch.float32),
                                     (1, 96, torch.bfloat16, torch.float32), (8, 256, torch.bfloat16, torch.bfloat16)]:
        cache = [0, 1, sp - 1, sp, sp + 1, 3 * sp]
        q = torch.randn((len(cache), gq, d), generator=gen, device=dev).to(q_dtype)
        k, vv = (torch.randn((len(cache), 3 * sp, d), generator=gen, device=dev).to(kv_dtype) for _ in range(2))
        cl = torch.tensor(cache, dtype=torch.int32, device=dev)
        got = dec.decode_attention(q, k, vv, cl)
        want = dec.merge_partials(*dec.decode_attention_partials_torch(q, k, vv, cl, scale=d**-0.5, block_s=512))[0]
        what = f"decode_attention merged path at Gq {gq}, D {d}, {kv_dtype} cache, {q_dtype} q, cache_len {cache}"
        err = close(got, want, DECODE_TOL, DECODE_TOL, what)
        close(got[0], vv[0].float().mean(0).expand(gq, d), DECODE_TOL, DECODE_TOL,
              f"{what}: cache_len = 0 must decode to the mean of v")
        report["decode_attention"]["max_abs_err"] = max(report["decode_attention"]["max_abs_err"], err)
        log(f"parity {what}: max abs err {err:.3e}")
    phases["parity_s"] = time.perf_counter() - t0

    # ------------------------------------------------- slice 1: the graph path
    rescaler = ElasticRescaler()
    packs, expected_launches = {}, 0
    oracle_counts = {}

    def oracle(k: int):
        if k not in oracle_counts:
            oracle_counts[k] = (
                metrics.replication_factor_ordered(src, dst, k, v),
                metrics.mirror_count_ordered(src, dst, k, v),
            )
        return oracle_counts[k]

    reset_launches()
    t_main = time.perf_counter()
    for k in PACK_KS + (8,):
        t0 = time.perf_counter()
        packs[k] = E.cep_engine_data(g, order, k, device=dev)
        torch.cuda.synchronize()
        phases[f"pack_k{k}_s"] = time.perf_counter() - t0
        expected_launches += 1
    rescales = {}
    for name, base, k_new in (("16to17", 16, 17), ("8to12", 8, 12), ("12to8", "8to12", 8)):
        data = packs[base] if isinstance(base, int) else rescales[base][0]
        plan = rescaler.plan(data, k_new)
        new, stats = rescaler.rescale(data, k_new, verify=True)
        expected_launches += 1
        rescales[name] = (new, stats, plan)
        phases[f"rescale_{name}_s"] = stats.elapsed_s
        phases[f"recheck_{name}_s"] = stats.recheck_s
    t0 = time.perf_counter()
    d17, d4 = rescales["16to17"][0], packs[4]
    pr17, pr4 = E.pagerank(d17, iterations=20), E.pagerank(d4, iterations=20)
    torch.cuda.synchronize()
    phases["pagerank_x2_s"] = time.perf_counter() - t0
    source = int(torch.argmax(d4.degrees))
    t0 = time.perf_counter()
    (ss17, it_s17), (ss4, it_s4) = E.sssp(d17, source=source), E.sssp(d4, source=source)
    phases["sssp_x2_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    (wc17, it_w17), (wc4, it_w4) = E.wcc(d17), E.wcc(d4)
    phases["wcc_x2_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    phases["main_path_s"] = time.perf_counter() - t_main
    slice1_launches = read_launches()

    for k in PACK_KS + (8,):
        rf, mir = oracle(k)
        check(packs[k].replication_factor == rf and packs[k].mirrors == mir,
              f"k={k}: RF/mirrors {packs[k].replication_factor}/{packs[k].mirrors} != oracle {rf}/{mir}")
        log(f"pack k={k}: RF {rf} mirrors {mir} (equal to the numpy oracle), {phases[f'pack_k{k}_s']:.3f} s")
    for name, (new, stats, plan) in rescales.items():
        rf, mir = oracle(new.k)
        check(stats.oracle_checked, f"rescale {name} was not byte-checked")
        check(stats.migrated_bytes == plan.migrated_bytes(EDGE_BYTES), f"rescale {name} moved other bytes than its plan")
        check(new.replication_factor == rf and new.mirrors == mir, f"rescale {name}: re-checked RF/mirrors differ from the oracle")
        log(f"rescale {name}: byte-equal to a fresh pack, migrated {stats.migrated_bytes} B in {stats.copy_ops} copies, "
            f"{stats.elapsed_s * 1e3:.3f} ms; re-checked RF {rf} (oracle) in {stats.recheck_s:.3f} s")
    back, orig = rescales["12to8"][0], packs[8]
    check(torch.equal(back.edges, orig.edges) and torch.equal(back.mask, orig.mask), "8→12→8 is not byte-identical")
    check(bool(torch.isfinite(pr17).all()) and abs(float(pr17.double().sum()) - 1.0) < 1e-3, "PageRank is not a distribution")
    pr_rel = float(((pr17 - pr4).abs() / pr4.abs()).max())
    check(pr_rel <= PAGERANK_RTOL, f"PageRank differs across k by rel {pr_rel}")
    check(torch.equal(ss17, ss4) and it_s17 == it_s4, "SSSP differs across k")
    check(torch.equal(wc17, wc4) and it_w17 == it_w4, "WCC differs across k")
    reached = int((ss4 < 1e9).sum())
    components = int(torch.unique(wc4[d4.degrees > 0]).numel())
    log(f"apps: PageRank k=17 vs k=4 max rel diff {pr_rel:.3e} (limit {PAGERANK_RTOL}); "
        f"SSSP from {source}: {it_s4} iterations, {reached} reached, equal; "
        f"WCC: {it_w4} iterations, {components} components, equal")
    check(slice1_launches == {**dict.fromkeys(KERNELS, 0), "segment_rf": expected_launches},
          f"slice 1 launched {slice1_launches}, expected segment_rf {expected_launches} times and nothing else")
    log(f"slice 1 launches: {slice1_launches} (segment_rf = {len(packs)} packs + {len(rescales)} re-checked rescales)")

    # Split of a pack's time: the host part alone (the rest is the copy to
    # the card, the row sort, the kernel and the degree count).
    t0 = time.perf_counter()
    E.host_pack(src, dst, 16)
    phases["host_pack_k16_s"] = time.perf_counter() - t0

    # ----------------------------------------------- slice 2: the entry points
    deg = d4.degrees.cpu().numpy()
    weights = (1.0 / np.maximum(deg[src], 1.0)).astype(np.float32)  # PageRank's gather: x[src] / deg[src]
    x_pr = pr4
    bounds16, bounds128 = np.asarray(cep.chunk_bounds(n, 16)), np.asarray(cep.chunk_bounds(n, 128))
    narrow = min(1 << 16, v // 16)  # 65,536 at scale 20
    narrow_starts = [int(np.clip(src[bounds16[i]:bounds16[i + 1]].min(), 0, v - narrow)) for i in range(16)]
    spmv_calls = {
        "a": (bounds16, [0] * 16, v),
        "b": (bounds128, [0] * 128, v),
        "c": (bounds16, narrow_starts, narrow),
    }
    (qwen_qkv, _), (gemma_qkv, gemma_kw) = prefill_inputs(gen, dev)
    q_heads, kv_heads, hd = QWEN3["heads"], QWEN3["kv_heads"], QWEN3["head_dim"]
    rep = q_heads // kv_heads
    bh_dec = DECODE_BATCH * kv_heads
    dec_q = torch.randn((bh_dec, rep, hd), generator=gen, device=dev, dtype=torch.bfloat16)
    dec_k, dec_v = (torch.randn((bh_dec, DECODE_CACHE, hd), generator=gen, device=dev, dtype=torch.bfloat16)
                    for _ in range(2))
    cache_np = decode_cache_lengths(bh_dec)
    dec_len = torch.from_numpy(cache_np).to(dev)
    torch.cuda.synchronize()

    reset_launches()
    t_slice2 = time.perf_counter()
    spmv_out = {}
    for name, (bounds, starts, size) in spmv_calls.items():
        t0 = time.perf_counter()
        spmv_out[name] = ops.chunked_spmv(src, dst, weights, x_pr, bounds, starts, size, device=dev)
        torch.cuda.synchronize()
        phases[f"chunked_spmv_{name}_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    qwen_out = ops.flash_attention(*qwen_qkv, causal=True)
    torch.cuda.synchronize()
    phases["flash_qwen3_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gemma_out = ops.flash_attention(*gemma_qkv, **gemma_kw)
    torch.cuda.synchronize()
    phases["flash_gemma2_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dec_out = ops.decode_attention(dec_q, dec_k, dec_v, dec_len, block_s=DECODE_BLOCK)
    torch.cuda.synchronize()
    phases["decode_qwen3_s"] = time.perf_counter() - t0
    phases["slice2_path_s"] = time.perf_counter() - t_slice2
    slice2_launches = read_launches()
    expected2 = {"segment_rf": 0, "edge_spmv": len(spmv_calls), "flash_attention": 2, "decode_attention": 1}
    slice2_tc, slice2_merges = fa.tc_launches, dec.merge_launches
    check(slice2_launches == expected2, f"slice 2 launched {slice2_launches}, expected {expected2}")
    check(slice2_tc == 2, f"slice 2's two bf16 flash calls ran the tensor-core kernel {slice2_tc} times, expected 2")
    check(slice2_merges == 1, f"slice 2's decode call ran the combine kernel {slice2_merges} times, expected 1")
    log(f"slice 2 launches: {slice2_launches}; flash_attention on the tensor cores: {slice2_tc}; "
        f"decode_attention's combine kernel: {slice2_merges}")

    x64 = x_pr.double().cpu().numpy()
    spmv_oracle = torch.from_numpy(np.bincount(dst, weights=weights.astype(np.float64) * x64[src], minlength=v))
    spmv_packs = {}  # each call's kernel input from the host oracle, for its out-of-window count and its timing
    for name, (bounds, starts, size) in spmv_calls.items():
        y = spmv_out[name]
        check(y.shape == (v,) and y.dtype == torch.float32 and bool(torch.isfinite(y).all()),
              f"chunked_spmv ({name}): not a finite (V,) f32 vector")
        rel = rel_close(y.cpu(), spmv_oracle, SPMV_RTOL, f"chunked_spmv ({name}) against the float64 oracle")
        spmv_packs[name] = ops.pack_windows(src, dst, weights, bounds, starts, size)
        outside = spmv_packs[name][3].size
        log(f"chunked_spmv ({name}) C={len(starts)} window {size}: max rel diff {rel:.3e} to the float64 oracle "
            f"(limit {SPMV_RTOL}); {outside} of {n} edges in the out-of-window pass; {phases[f'chunked_spmv_{name}_s']:.3f} s")

        # The call once more, whole and then phase by phase, each phase
        # ended by a synchronize; the phases run the entry point's own steps.
        st = np.asarray(starts, dtype=np.int64)
        y_whole, whole_s = synced_s(lambda: ops.chunked_spmv(src, dst, weights, x_pr, bounds, starts, size, device=dev))
        (s_t, d_t, w_t), h2d_s = synced_s(lambda: ops._edges_to_device(src, dst, weights, v, dev))
        packed, pack_s = synced_s(lambda: ops.pack_windows_device(s_t, d_t, w_t, bounds, st, size, device=dev))
        x_win, xwin_s = synced_s(lambda: ops._x_windows(x_pr, st, size))
        y_win, kernel_s = synced_s(lambda: edge_spmv.spmv_blocked(*packed[:3], x_win))
        y2, add_s = synced_s(lambda: ops._add_back(y_win, st, v))
        _, outside_s = synced_s(lambda: ops._add_outside(y2, s_t, d_t, w_t, x_pr, packed[3]))
        rel_close(y2[:v].cpu(), spmv_oracle, SPMV_RTOL, f"chunked_spmv ({name}) run phase by phase")
        rel_close(y2[:v], y_whole, SPMV_RTOL, f"chunked_spmv ({name}): the phases against the entry point's own call")
        split = dict(again=whole_s, h2d=h2d_s, pack=pack_s, x_windows=xwin_s, kernel=kernel_s, add_back=add_s,
                     outside=outside_s)
        phases.update({f"chunked_spmv_{name}_{k}_s": t for k, t in split.items()})
        log(f"chunked_spmv ({name}) again: {whole_s * 1e3:.3f} ms; phases in ms: "
            + ", ".join(f"{k} {t * 1e3:.3f}" for k, t in split.items() if k != "again"))
        # The device packing, byte-equal to the host oracle at full size.
        for part, got_p, want_p in zip(("src_l", "dst_l", "wts", "outside"), packed, spmv_packs[name]):
            got_np = got_p.cpu().numpy()
            check(got_np.dtype == want_p.dtype and got_np.shape == want_p.shape and got_np.tobytes() == want_p.tobytes(),
                  f"pack_windows_device ({name}) {part}: not byte-equal to pack_windows")
        log(f"pack_windows_device ({name}): byte-equal to the numpy pack_windows, (C, W_E) = {tuple(packed[0].shape)}")
        del s_t, d_t, w_t, packed, x_win, y_win, y2, y_whole
    check(spmv_packs["c"][3].size > 0, "call (c) must have out-of-window edges")

    for what, out, qkv, kw in (("qwen3-8b", qwen_out, qwen_qkv, dict(causal=True)),
                               ("gemma2-9b local", gemma_out, gemma_qkv, gemma_kw)):
        check(out.dtype == torch.bfloat16 and out.shape == qkv[0].shape and bool(torch.isfinite(out).all()),
              f"flash_attention ({what}): not a finite bf16 tensor of q's shape")
        want = flash_plain(fa.flash_attention_torch, qkv, kw)
        err = close(out, want, BF16_RTOL, BF16_ATOL, f"flash_attention ({what}) against the plain version")
        report["flash_attention"]["max_abs_err"] = max(report["flash_attention"]["max_abs_err"], err)
        log(f"flash_attention ({what}) {tuple(out.shape)}: max abs err {err:.3e} to the plain version "
            f"(run {FLASH_HEAD_GROUP} heads at a time), {tol_ratio(out, want, BF16_RTOL, BF16_ATOL):.3f} of the "
            f"limit {BF16_ATOL} + 2^-7·|plain|")
        if kw.get("window") is None and kw.get("softcap") is None:
            # A reading, not a gate: SDPA rounds P to bf16 once before P·V.
            sdpa = torch.nn.functional.scaled_dot_product_attention(*qkv, is_causal=True)
            log(f"SDPA ({what}): {tol_ratio(sdpa, want, BF16_RTOL, BF16_ATOL):.3f} of the same limit "
                f"(max abs err {float((sdpa.float() - want.float()).abs().max()):.3e}; a reading, not a check)")
            del sdpa
        del want
    check(dec_out.shape == (bh_dec, rep, hd) and bool(torch.isfinite(dec_out).all()), "decode: not finite")
    dec_plain = dec.merge_partials(*dec.decode_attention_partials_torch(
        dec_q, dec_k, dec_v, dec_len, scale=hd**-0.5, block_s=DECODE_BLOCK))[0]
    err = close(dec_out, dec_plain, DECODE_TOL, DECODE_TOL, "decode_attention (qwen3-8b) against the plain version")
    report["decode_attention"]["max_abs_err"] = max(report["decode_attention"]["max_abs_err"], err)
    log(f"decode_attention (qwen3-8b) q {tuple(dec_q.shape)} cache {tuple(dec_k.shape)} bf16, cache_len "
        f"{int(dec_len.min())}..{int(dec_len.max())}: max abs err {err:.3e} to the plain version, limit {DECODE_TOL}")
    del spmv_out, qwen_out, gemma_out, dec_out, dec_plain
    torch.cuda.empty_cache()

    # ------------------------------------------------ kernel times vs bounds
    rows16 = ops.packed_rows(packs[16].edges, packs[16].mask)
    c, w = rows16.shape
    check(torch.equal(segment_rf.segment_distinct_counts(rows16), segment_rf.segment_distinct_counts_torch(rows16)),
          "segment_rf parity failed on the real k=16 rows")
    bytes_ms = (c * w * 4 + c * 4) / H100_BYTES_PER_S * 1e3
    ops_ms = 3 * c * w / H100_FP32_OPS_PER_S * 1e3
    report["segment_rf"].update(
        shape=[c, w], ms=cuda_ms(lambda: segment_rf.segment_distinct_counts(rows16), 50),
        plain_ms=cuda_ms(lambda: segment_rf.segment_distinct_counts_torch(rows16), 20),
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations", library_ms=None)
    del rows16

    spmv_times = []
    for name, (bounds, starts, size) in spmv_calls.items():
        src_l, dst_l, wts, _ = spmv_packs.pop(name)
        args_t = [torch.from_numpy(a).to(dev) for a in (src_l, dst_l, wts)]
        x_pad = torch.cat([x_pr, x_pr.new_zeros(size)])
        x_win = x_pad.unfold(0, size, 1)[torch.tensor(starts, device=dev)]
        got = edge_spmv.spmv_blocked(*args_t, x_win)
        want = edge_spmv.spmv_blocked_torch(*args_t, x_win)
        rel = rel_close(got, want, SPMV_RTOL, f"edge_spmv ({name}) against the plain version")
        report["edge_spmv"]["max_abs_err"] = max(report["edge_spmv"]["max_abs_err"], float((got - want).abs().max()))
        # The library yardstick: index_add_ of the precomputed products into
        # the flat output. It leaves out the gather of x, the product and the
        # padding filter, which the kernel does.
        valid = args_t[0] < size
        flat = (torch.arange(len(starts), device=dev)[:, None] * size + args_t[1])[valid]
        prod = (args_t[2] * x_win.gather(1, torch.where(valid, args_t[0], 0).long()))[valid]
        lib_ms = cuda_ms(lambda: torch.zeros(len(starts) * size, device=dev).index_add_(0, flat, prod), 20)
        c_, w_e = src_l.shape
        # Bytes the function must move: the two ids of every slot, the weight
        # of every valid slot only (a padding slot's weight adds nothing), the
        # (C, W_V) output, and of x_win only the entries the gather reads
        # (the distinct in-window src ids of each chunk).
        n_valid = int(valid.sum())
        gathered = int(torch.unique((torch.arange(c_, device=dev)[:, None] * size + args_t[0])[valid]).numel())
        spmv_bytes = 8 * c_ * w_e + 4 * n_valid + 4 * c_ * size + 4 * gathered
        ms = cuda_ms(lambda: edge_spmv.spmv_blocked(*args_t, x_win), 20)
        bound_ms = spmv_bytes / H100_BYTES_PER_S * 1e3
        spmv_times.append(dict(
            shape=[c_, w_e, size], ms=ms, plain_ms=cuda_ms(lambda: edge_spmv.spmv_blocked_torch(*args_t, x_win), 5),
            bound_ms=bound_ms, bound_by="bytes", bound_share=bound_ms / ms, library_ms=lib_ms, valid_slots=n_valid,
            x_read=gathered))
        log(f"edge_spmv ({name}) (C, W_E, W_V) = ({c_}, {w_e}, {size}): {ms:.4f} ms, plain "
            f"{spmv_times[-1]['plain_ms']:.4f} ms, index_add_ {lib_ms:.4f} ms ({lib_ms / ms:.3f}× the kernel's time), "
            f"bound {bound_ms:.4f} ms ({bound_ms / ms:.3f} of it; {spmv_bytes} B, {n_valid} valid slots, {gathered} "
            f"distinct x entries gathered); max rel diff to the plain version {rel:.3e}")
        del args_t, x_pad, x_win, got, want, valid, flat, prod
    report["edge_spmv"].update(spmv_times[0], other_shapes=spmv_times[1:])

    flash_times = []
    for what, qkv, kw in (("qwen3-8b", qwen_qkv, dict(causal=True)), ("gemma2-9b local", gemma_qkv, gemma_kw)):
        b, h, s, d = qkv[0].shape
        flops = 4 * b * h * d * visible_pairs(s, kw["causal"], kw.get("window"))
        bytes_ms = 4 * qkv[0].numel() * qkv[0].element_size() / H100_BYTES_PER_S * 1e3
        ops_ms = flops / H100_BF16_OPS_PER_S * 1e3
        lib_ms = None
        if kw.get("window") is None and kw.get("softcap") is None:
            lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(*qkv, is_causal=True), 10)
        flash_times.append(dict(
            shape=[b, h, s, d], ms=cuda_ms(lambda: fa.flash_attention(*qkv, **kw), 10),
            plain_ms=cuda_ms(lambda: flash_plain(fa.flash_attention_torch, qkv, kw), 2),
            bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=lib_ms, gflop=flops / 1e9))
        ft = flash_times[-1]
        log(f"flash_attention ({what}) {ft['shape']}: {ft['ms']:.3f} ms, plain {ft['plain_ms']:.3f} ms, "
            f"SDPA {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, bound {ft['bound_ms']:.4f} ms "
            f"({ft['gflop']:.1f} GFLOP, {ft['gflop'] / ft['ms']:.2f} TFLOP/s achieved)")
    report["flash_attention"].update(flash_times[0], other_shapes=flash_times[1:])
    del qwen_qkv, gemma_qkv
    torch.cuda.empty_cache()

    row_bytes = hd * dec_k.element_size()
    valid = np.minimum(cache_np.astype(np.int64), DECODE_CACHE)
    dec_bytes = int(valid.sum()) * 2 * row_bytes  # K and V below cache_len
    dec_bytes += dec_q.numel() * dec_q.element_size() + bh_dec * rep * hd * 4 + bh_dec * 4
    # What the two kernels move: the split kernel reads q, cache_len and K/V
    # below cache_len (V of every key of a row with cache_len = 0) and writes
    # (o, m, l) of each split it runs; the combine reads those and writes out.
    splits_run = int(np.where(valid >= 1, -(-valid // dec.SPLIT), -(-DECODE_CACHE // dec.SPLIT)).sum())
    kv_read = int(np.where(valid >= 1, 2 * valid, DECODE_CACHE).sum()) * row_bytes
    partial_bytes = splits_run * rep * (hd + 2) * 4
    kernel_bytes = kv_read + dec_q.numel() * dec_q.element_size() + 2 * bh_dec * 4 + 2 * partial_bytes \
        + bh_dec * rep * hd * 4
    partials_kv_read = int((valid + DECODE_CACHE).sum()) * row_bytes  # the V of every tile, K below cache_len
    mask3 = torch.arange(DECODE_CACHE, device=dev)[None, None, :] < dec_len[:, None, None]
    q4, k4, v4 = dec_q[:, None], dec_k[:, None], dec_v[:, None]  # (64, 1, 4, 128) and (64, 1, 32768, 128)
    mask4 = mask3[:, None]  # (64, 1, 1, 32768) bool
    sdpa3 = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(dec_q, dec_k, dec_v, attn_mask=mask3), 20)
    sdpa4 = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask4), 20)
    ms = cuda_ms(lambda: dec.decode_attention(dec_q, dec_k, dec_v, dec_len, block_s=DECODE_BLOCK), 20)
    report["decode_attention"].update(
        shape=[bh_dec, rep, DECODE_CACHE, hd], ms=ms,
        plain_ms=cuda_ms(lambda: dec.merge_partials(*dec.decode_attention_partials_torch(
            dec_q, dec_k, dec_v, dec_len, scale=hd**-0.5, block_s=DECODE_BLOCK)), 3),
        bound_ms=dec_bytes / H100_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=min(sdpa3, sdpa4),
        sdpa_3d_mask_ms=sdpa3, sdpa_4d_bool_mask_ms=sdpa4, kernel_bytes=kernel_bytes,
        kernel_tb_per_s=kernel_bytes / (ms * 1e-3) / 1e12, splits_run=splits_run,
        partials_ms=cuda_ms(lambda: dec.decode_attention_partials(dec_q, dec_k, dec_v, dec_len, block_s=DECODE_BLOCK),
                            20),
        partials_kv_bytes=partials_kv_read)
    r = report["decode_attention"]
    log(f"decode_attention (qwen3-8b) {r['shape']}: {r['ms']:.4f} ms (split kernel + combine kernel), plain "
        f"{r['plain_ms']:.4f} ms, SDPA with a cache_len mask {sdpa3:.4f} ms (3-D, float mask) / {sdpa4:.4f} ms "
        f"(4-D, bool mask), bound {r['bound_ms']:.4f} ms ({dec_bytes / 1e9:.3f} GB below cache_len, "
        f"{r['bound_ms'] / r['ms']:.3f} of it); the kernels move {kernel_bytes} B ({kv_read} B of K/V, "
        f"{splits_run} splits of {dec.SPLIT} keys) at {r['kernel_tb_per_s']:.3f} TB/s; "
        f"partials entry point {r['partials_ms']:.4f} ms "
        f"({partials_kv_read} B of K/V: V of every tile)")
    del dec_q, dec_k, dec_v, mask3, mask4, q4, k4, v4

    phases = {k: round(x, 6) for k, x in phases.items()}
    log(json.dumps({"phases": phases, "graph": {"scale": args.scale, "edge_factor": args.edge_factor,
                                                "num_vertices": v, "num_edges": n}}))
    sources = {
        "segment_rf": "src/repro/kernels/segment_rf.py:44",
        "edge_spmv": "src/repro/kernels/edge_spmv.py:52",
        "flash_attention": "src/repro/kernels/flash_attention.py:117",
        "decode_attention": "src/repro/kernels/decode_attention.py:76",
    }
    launches = {**{k: n_ for k, n_ in slice1_launches.items() if n_}, **{k: n_ for k, n_ in slice2_launches.items() if n_}}
    kernels = []
    for name in KERNELS:
        r = report[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": sources[name],
            "launches": launches[name],
            "parity": "exact" if name == "segment_rf" else "allclose",
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": r["shape"],
            **({"tc_launches": slice2_tc} if name == "flash_attention" else {}),
            **({"merge_launches": slice2_merges} if name == "decode_attention" else {}),
            **{key: r[key] for key in ("partials_ms", "sdpa_3d_mask_ms", "sdpa_4d_bool_mask_ms", "kernel_bytes",
                                       "kernel_tb_per_s") if key in r},
            **({"bound_share": r["bound_share"]} if "bound_share" in r else {}),
            **({"other_shapes": r["other_shapes"]} if "other_shapes" in r else {}),
        })
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
