#!/usr/bin/env python3
"""Time design variants of the kernels B5, B1, B7, B3, B6 and B4 on a CUDA card.

    python3 scripts/kernel_variants.py [b5 b1 b7 b3 b6 b4 b2]   # repo root, on the card

(no names: all seven).
Each variant is the shipped source (``src/repro_torch/csrc``) with one
textual change, built with the same nvcc flags into ``build/variants/``
and called through ctypes beside the shipped kernel, at chip_smoke.py's
main and long shapes, in alternating rounds.  Every output is held to
the plain twin under chip_smoke.py's 2-ulp rule; a variant that breaks
it is printed with its error ratio (the diagnostics do so on purpose).

B5 (``flash_attention``, bf16):
  shipped     -- 64-key tiles scored in 32-key steps at d = 128;
  steps64     -- 64-key score steps at d = 128 (spills at 128 registers);
  one_bf16_p  -- P.V with p_hi only (diagnostic: what p_lo costs);
  fast_exp    -- __expf for the probabilities (diagnostic: what expf costs).
B1 (``flash_attention_decode_paged``), at chip_smoke.py's main and long
shapes and its served verify spans (8 sequences at sq = 5, bf16 and int8
pages), each at n_split 1 and as chosen:
  shipped     -- the next tile's pages copied while the current is scored;
  no_prefetch -- each tile copied, then waited for, before it is scored;
  span_rows   -- a tried design: in a verify span a thread scores one key
                 for 4 query rows and sums P.V for 4 rows, each K/V read
                 converted once (``baselines/flash_decode_paged_span_rows.cu``).
B7 (``tree_row_reduce``, bit for bit), at the main shape (a warp per row)
and the long one (split over CTAs, at several split counts beside the
one ``tree_splits`` chooses):
  shipped     -- subtrees of 8 leaves, streaming 16-byte loads into
                 registers, the loop over subtrees unrolled by 2;
  no_unroll   -- the loop not unrolled;
  ldg         -- read-only loads instead of streaming ones (evict first);
  leaves16    -- subtrees of 16 leaves;
  rows4       -- 4 rows (warps) per CTA instead of 8;
  residues256 -- 256 residues per split CTA instead of 512 (the scratch
                 is allocated for 512, so it is large enough).
B3 (``flash_attention_decode``): the shipped kernel at n_split 1 and as
``dense_splits`` chooses.
B6 (``ssd_scan``), at chip_smoke.py's main, long and zamba2 shapes, each
held to the plain twin as a share of the 2e-4 rule, and at the main shape
each variant's time split over its kernels (``torch.profiler``):
  shipped     -- the chunk-parallel kernels, products in 3xTF32;
  split_bf16  -- the same, products as three split-bf16 products;
  fp32_cores  -- the same tiles, products in fp32 on the CUDA cores;
  one_tf32    -- one TF32 product (diagnostic: what the split buys);
  no_state_products, no_out_products -- the shipped kernels without the
                 products of kernel 2, or of kernel 4 (diagnostics, wrong
                 outputs: what the loads, exps and syncs cost alone);
  serial      -- the earlier design, one CTA per (b, h, dh slab) walking
                 the chunks in order (``baselines/ssd_scan_serial.cu``).
B4 (``rmsnorm``) at (4096, 3072) and (8, 3072) bf16 beside ``F.rms_norm``:
the shipped kernel at the plan ``rmsnorm_plan`` picks and at other warps
per row and rows per CTA; a copy of x (``clone``, the floor of a
function that reads x and writes y once), after the usual flush and
after one that leaves clean lines in L2; and the earlier design, one
CTA of 128 threads per row and two passes over it
(``baselines/rmsnorm_two_pass.cu``).
B2 (``kv_quantize`` and ``kv_quantize_store``, bit for bit), at the slot
cache (8·8·1024 x 128 bf16), a prefill (8·128·8 x 128), the decode rows
(64 x 128) and the store's decode rows (8 slots x 8 kv heads, K and V)
and paged chunk (1 x 128 tokens x 8 kv heads): the shipped kernel at the
plan ``kv_quant_plan`` picks and at other lanes per row, vectors per
lane and threads per CTA; a copy of x (``clone``) after both flushes; the earlier design, a warp per
row and one launch per input (``baselines/kv_quant_warp_row.cu``), with
the store's rows written by ``index_put_`` (the separate route); and at
the quantize shapes, with the chosen plan:
  plain_loads -- cached loads instead of streaming ones;
  rintf       -- rintf and float clamps, then a conversion, instead of
                 one __float2int_rn and integer clamps (the same values);
  mul_recip   -- x times a reciprocal of the scale (diagnostic, not the
                 reference's division: what the division costs).
"""

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import kv_quant as kq  # noqa: E402
from repro_torch.kernels import rmsnorm_kernel as rk  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.kernels import treereduce_kernel as tk  # noqa: E402

B5 = {
    "shipped": {},
    "steps64": {"static constexpr int BC = D <= 64 ? 64 : 32;":
                "static constexpr int BC = D <= 128 ? 64 : 32;"},
    "one_bf16_p": {"      mma_bf16(o[2 * jj], lo, bb[0], bb[1]);\n": "",
                   "      mma_bf16(o[2 * jj + 1], lo, bb[2], bb[3]);\n": ""},
    "fast_exp": {"const float x = expf(s[j][e] - m_r[e >> 1]);":
                 "const float x = __expf(s[j][e] - m_r[e >> 1]);"},
}
B1 = {
    "shipped": {},
    "no_prefetch": {
        "    load(0, 0);\n    cp_async_commit();\n": "",
        "    cp_async_wait_all();\n":
            "    __syncthreads();\n    load(slot, st);\n    cp_async_commit();\n"
            "    cp_async_wait_all();\n",
        "    if (t + 1 < my_hi) {\n      load((i + 1) % 3, st ^ 1);\n"
        "      cp_async_commit();\n    }\n": ""},
}

B7 = {
    "shipped": {},
    "no_unroll": {"#pragma unroll 2\n  for (int k = 0; k < nchunks; ++k) {":
                  "  for (int k = 0; k < nchunks; ++k) {"},
    "ldg": {"__ldcs(reinterpret_cast<const uint4*>(row + (in[h] ? i : 0)))":
            "__ldg(reinterpret_cast<const uint4*>(row + (in[h] ? i : 0)))"},
    "leaves16": {"constexpr int kMaxLeaves = 8; ":
                 "constexpr int kMaxLeaves = 16; "},
    "rows4": {"constexpr int kWarpRowsPerCta = 8; ":
              "constexpr int kWarpRowsPerCta = 4; "},
    "residues256": {"constexpr int kSplitResidues = 512; ":
                    "constexpr int kSplitResidues = 256; "},
}


B6 = {
    "shipped": {},
    "split_bf16": {"#define SSD_PRODUCT 0": "#define SSD_PRODUCT 1"},
    "fp32_cores": {"#define SSD_PRODUCT 0": "#define SSD_PRODUCT 2"},
    "one_tf32": {"#define SSD_PRODUCT 0": "#define SSD_PRODUCT 3"},
    # diagnostics (wrong outputs): each kernel's time without its products.
    "no_state_products": {
        "load_a(fa, bs + k0 * ldb + mt * 16, 1, ldb);\n        mma(acc[u], fa, fb);":
        "load_a(fa, bs + k0 * ldb + mt * 16, 1, ldb);"},
    "no_out_products": {
        "               sc ? sc + k0 : nullptr);\n        mma(acc[u], fa, fb);":
        "               sc ? sc + k0 : nullptr);",
        "load_b(fb, SS + k0 * lds + ((w >> 2) + 2 * u) * 8, lds, 1);\n"
        "        mma(acc[u], fa, fb);":
        "load_b(fb, SS + k0 * lds + ((w >> 2) + 2 * u) * 8, lds, 1);"},
}
BASELINES = os.path.join(ROOT, "scripts", "baselines")


def build_variants(source: str, variants: dict, symbol: str, argtypes,
                   path=None):
    """{name: ctypes function} of each variant, all nvcc runs at once.
    ``path``: the source to vary (default ``csrc/<source>.cu``)."""
    text = open(path or build.CSRC / f"{source}.cu").read()
    out_dir = os.path.join(ROOT, "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        t = text
        for old, new in subs.items():
            if old not in t:
                raise SystemExit(f"{source} variant {name}: source changed")
            t = t.replace(old, new)
        path = os.path.join(out_dir, f"{source}_{name}.cu")
        with open(path, "w") as f:
            f.write(t)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{report}")
        for fn, regs, spill in cs.ptxas_entries(report):
            print(f"  {source} {name}: {fn.split('(')[0]}: {regs} registers, "
                  f"{spill} bytes of spill stores")
        fn = getattr(ctypes.CDLL(os.path.join(out_dir, f"{source}_{name}.so")),
                     symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def err_ratio(out, ref):
    try:
        return cs.hold("variant", "", out, ref, "bf16")["err_over_tol"]
    except AssertionError as e:
        return str(e).split(": ", 1)[1]


def run_b5(gen, flush, stream):
    b5 = build_variants("flash_attention", B5, "flash_attention",
                        fa._flash_kernel().argtypes)
    for case, kw in (("main", {}), ("long", dict(b=1, sq=8192, sk=8192))):
        q, k, v = cs.make_attention(gen, **kw)
        b, hq, sq, d = q.shape
        hkv, sk = k.shape[1], k.shape[2]
        ref = fa.flash_attention_plain(q, k, v)
        out = torch.empty_like(q)
        for rnd in range(2):
            for name, fn in b5.items():
                def call():
                    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), b, hq, hkv, sq, sk, d, 1, 0,
                              float(d ** -0.5), 1, stream)
                assert call() == 0
                torch.cuda.synchronize()
                print(f"B5 {case} round {rnd} {name}: ms "
                      f"{cs.time_ms(call, flush)}, err/tol {err_ratio(out, ref)}",
                      flush=True)
        del q, k, v, ref, out


def run_b1(gen, flush, stream):
    argtypes = fa._kernel().argtypes
    b1 = build_variants("flash_decode_paged", B1, "flash_decode_paged",
                        argtypes)
    b1.update(build_variants(
        "flash_decode_paged_span_rows", {"span_rows": {}},
        "flash_decode_paged", argtypes,
        os.path.join(BASELINES, "flash_decode_paged_span_rows.cu")))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    main = dict(b=8, n_blocks=64, max_pos=1024)
    for case, kw in (("main", main),
                     ("long", dict(b=32, n_blocks=256, max_pos=4096)),
                     ("verify sq=5", dict(main, sq=5)),
                     ("verify sq=5 int8", dict(main, sq=5, quant=True))):
        c = cs.make_case(gen, **kw)
        ref = fa.flash_attention_decode_paged_plain(**c)
        b, hq, sq, d = c["q"].shape
        n_pages, hkv, page, _ = c["k_pages"].shape
        nb = c["block_tab"].shape[1]
        quant = c["k_scale_pages"] is not None
        scales = ((c["k_scale_pages"].data_ptr(),
                   c["v_scale_pages"].data_ptr()) if quant else (None, None))
        chosen = fa.paged_splits(b, hkv, nb, page, n_sm)
        out = torch.empty_like(c["q"])
        for rnd in range(2):
            for name, fn in b1.items():
                for ns in sorted({1, chosen}):
                    rows = sq * hq // hkv
                    pa = torch.empty((b, hkv, ns, rows, d), device="cuda")
                    pm = torch.empty((b, hkv, ns, rows, 2), device="cuda")

                    def call():
                        return fn(c["q"].data_ptr(), c["k_pages"].data_ptr(),
                                  c["v_pages"].data_ptr(), *scales,
                                  c["block_tab"].data_ptr(),
                                  c["pos"].data_ptr(), None, out.data_ptr(),
                                  pa.data_ptr(), pm.data_ptr(), b, hq, hkv,
                                  sq, d, n_pages, page, nb, ns, 0,
                                  float(d ** -0.5), 1, int(quant), stream)
                    assert call() == 0
                    torch.cuda.synchronize()
                    print(f"B1 {case} round {rnd} {name} n_split {ns}: ms "
                          f"{cs.time_ms(call, flush)}, err/tol "
                          f"{err_ratio(out, ref)}", flush=True)
        del c, ref, out


def run_b7(gen, flush, stream):
    b7 = build_variants("treereduce", B7, "tree_row_reduce",
                        tk._kernel().argtypes)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for case, rows, n in (("main", 32768, 4096), ("long", 16, 256000)):
        x = torch.randn((rows, n), generator=gen, device="cuda")
        chosen = tk.tree_splits(rows, n, n_sm)
        splits = [1] if chosen == 1 else sorted({chosen // 2, chosen,
                                                  chosen * 2})
        out = torch.empty(rows, device="cuda")
        for op in ("add", "max"):
            ref = tk.tree_row_reduce_plain(x, op)
            lib = (torch.sum if op == "add" else torch.amax)
            for rnd in range(2):
                print(f"B7 {case} {op} round {rnd} library: ms "
                      f"{cs.time_ms(lambda: lib(x, -1), flush)}", flush=True)
                for name, fn in b7.items():
                    for ns in splits:
                        part = torch.empty((rows, tk.TREE_SPLIT_RESIDUES * ns),
                                           device="cuda")

                        def call():
                            return fn(x.data_ptr(), out.data_ptr(),
                                      part.data_ptr(), rows, n, ns,
                                      int(op == "max"), 0, stream)
                        assert call() == 0
                        torch.cuda.synchronize()
                        print(f"B7 {case} {op} round {rnd} {name} n_split "
                              f"{ns}: ms {cs.time_ms(call, flush)}, "
                              f"bit-equal {torch.equal(out, ref)}",
                              flush=True)
        del x, out


def run_b3(gen, flush, stream):
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    fn = fa._dense_kernel()
    for case, kw in (("main", {}), ("long", dict(b=32, S=4096,
                                                 max_pos=4096))):
        c = cs.make_dense_case(gen, **kw)
        ref = fa.flash_attention_decode_plain(**c)
        b, hq, _, d = c["q"].shape
        hkv, S = c["k"].shape[1], c["k"].shape[2]
        chosen = fa.dense_splits(b, hkv, S, n_sm)
        out = torch.empty_like(c["q"])
        for rnd in range(2):
            for ns in sorted({1, chosen}):
                pa = torch.empty((b, hkv, ns, hq // hkv, d), device="cuda")
                pm = torch.empty((b, hkv, ns, hq // hkv, 2), device="cuda")

                def call():
                    return fn(c["q"].data_ptr(), c["k"].data_ptr(),
                              c["v"].data_ptr(), c["pos"].data_ptr(),
                              out.data_ptr(), pa.data_ptr(), pm.data_ptr(),
                              b, hq, hkv, S, d, ns, 0, 0, float(d ** -0.5),
                              1, stream, 0, None, None)
                assert call() == 0
                torch.cuda.synchronize()
                print(f"B3 {case} round {rnd} n_split {ns}: ms "
                      f"{cs.time_ms(call, flush)}, err/tol "
                      f"{err_ratio(out, ref)}", flush=True)
        del c, ref, out


def run_b6(gen, flush, stream):
    b6 = build_variants("ssd_scan", B6, "ssd_scan", ss._kernel().argtypes)
    old = build_variants("ssd_scan_serial", {"serial": {}}, "ssd_scan",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p],
                         os.path.join(BASELINES, "ssd_scan_serial.cu")
                         )["serial"]
    for case, (b, s, h, dh, ds, chunk) in (
            ("main", (4, 2048, 64, 64, 128, 256)),
            ("long", (1, 16384, 64, 64, 128, 256)),
            ("zamba2", (4, 2048, 64, 64, 64, 256))):
        x, dt, A, B, C = cs.ssd_inputs(gen, b, s, h, dh, ds)
        ref = ss.ssd_scan_plain(x, dt, A, B, C, chunk)
        plan = ss.ssd_plan(b, s, h, dh, ds, chunk)
        scratch = [torch.empty(plan["scratch"][k], device="cuda")
                   for k in ("G", "S", "L")]
        y = torch.empty_like(x)
        ptrs = [t.data_ptr() for t in (x, dt, A, B, C, y)]
        calls = {name: (lambda fn=fn: fn(
            *ptrs, *(t.data_ptr() for t in scratch), b, s, h, dh, ds, chunk,
            plan["dhs"], stream)) for name, fn in b6.items()}
        calls["serial"] = lambda: old(*ptrs, b, s, h, dh, ds, chunk, stream)
        print(f"B6 {case}: ctas {plan['ctas']}, scratch bytes "
              f"{plan['scratch_bytes']}", flush=True)
        for rnd in range(2):
            for name, call in calls.items():
                y.fill_(float("nan"))
                assert call() == 0
                torch.cuda.synchronize()
                lim = 2e-4 + 2e-4 * ref.abs()
                share = ((y - ref).abs() / lim).max().item()
                print(f"B6 {case} round {rnd} {name}: ms "
                      f"{cs.time_ms(call, flush)}, err/tol {share:.4g}",
                      flush=True)
        if case == "main":
            for name, call in calls.items():
                print(f"B6 main {name}, device us per kernel: "
                      f"{kernel_split(call)}", flush=True)
        del x, dt, A, B, C, ref, scratch, y


def kernel_split(call, n=5):
    """{kernel: device microseconds per call} of ``call`` from a
    ``torch.profiler`` trace of ``n`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            m = re.search(r"ssd_\w+", ev.name)
            key = m.group(0) if m else ev.name[:40]
            out[key] = out.get(key, 0.0) + ev.time_range.elapsed_us() / n
    return {k: round(v, 1) for k, v in out.items()}


def run_b4(gen, flush, stream):
    fn = rk._kernel()
    old = build_variants("rmsnorm_two_pass", {"two_pass": {}}, "rmsnorm",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                            ctypes.c_void_p],
                         os.path.join(BASELINES, "rmsnorm_two_pass.cu")
                         )["two_pass"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for rows, d in ((4096, 3072), (8, 3072)):
        x = torch.randn((rows, d), generator=gen, device="cuda").bfloat16()
        w = (torch.randn(d, generator=gen, device="cuda") * 0.1).bfloat16()
        w1 = (1.0 + w.float()).bfloat16()
        ref = rk.rmsnorm_plain(x, w)
        out = torch.empty_like(x)
        chosen = rk.rmsnorm_plan(rows, d, 2, n_sm)
        plans = sorted({chosen, (1, 1), (1, 2), (1, 4), (1, 8), (2, 2),
                        (4, 1), (8, 1), (0, 1)})
        calls = {f"wpr {p[0]} rpc {p[1]}"
                 + (" (chosen)" if p == chosen else ""):
                 (lambda p=p: fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                 rows, d, 1e-6, 1, 1, p[0], p[1], stream))
                 for p in plans}
        calls["two_pass"] = lambda: old(x.data_ptr(), w.data_ptr(),
                                        out.data_ptr(), rows, d, 1e-6, 1, 1,
                                        stream)
        F = torch.nn.functional
        # a flush that leaves the L2 full of clean lines (a read), beside
        # the usual one (a write, whose dirty lines the kernel's own
        # traffic must write back): what the flush's write-backs cost.
        calls["chosen, read flush"] = calls[next(k for k in calls
                                                  if "chosen" in k)]
        read_flush = type("ReadFlush", (), {"zero_": lambda self: flush.view(
            torch.float32).sum()})()

        def lib():
            return F.rms_norm(x, (d,), weight=w1, eps=1e-6)

        for rnd in range(2):
            print(f"B4 {rows} x {d} round {rnd} F.rms_norm: ms "
                  f"{cs.time_ms(lib, flush)}"
                  f", x.clone() (copy floor): ms "
                  f"{cs.time_ms(x.clone, flush)}, with a read flush "
                  f"{cs.time_ms(x.clone, read_flush)}", flush=True)
            for name, call in calls.items():
                assert call() == 0
                torch.cuda.synchronize()
                fl = read_flush if "read flush" in name else flush
                print(f"B4 {rows} x {d} round {rnd} {name}: ms "
                      f"{cs.time_ms(call, fl)}, err/tol "
                      f"{err_ratio(out, ref)}", flush=True)
        del x, w, w1, ref, out


B2 = {
    "plain_loads": {"? __ldcs(x + c) :": "? x[c] :"},
    "rintf": {"""        o[k] = static_cast<int8_t>(min(max(
            __float2int_rn(__fdiv_rn(v[j][k], scale)), -127), 127));""":
              """        o[k] = static_cast<int8_t>(static_cast<int>(fminf(fmaxf(
            rintf(__fdiv_rn(v[j][k], scale)), -127.f), 127.f)));"""},
    "mul_recip": {
        "  const float scale = __fdiv_rn(fmaxf(amax, 1e-6f), 127.0f);\n":
        "  const float scale = __fdiv_rn(fmaxf(amax, 1e-6f), 127.0f);\n"
        "  const float inv = __frcp_rn(scale);\n",
        "__float2int_rn(__fdiv_rn(v[j][k], scale))":
        "__float2int_rn(v[j][k] * inv)"},
}


def run_b2(gen, flush, stream):
    quant, store, _ = kq._kernels()
    texts = build_variants("kv_quant", B2, "kv_quantize",
                           [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                           + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    old = build_variants("kv_quant_warp_row", {"warp_row": {}}, "kv_quantize",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                         + [ctypes.c_void_p],
                         os.path.join(BASELINES, "kv_quant_warp_row.cu")
                         )["warp_row"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    read_flush = type("ReadFlush", (), {"zero_": lambda self: flush.view(
        torch.float32).sum()})()
    d = 128
    others = [(8, 2, 128), (8, 2, 256), (8, 2, 64), (16, 1, 64),
              (16, 1, 128), (16, 1, 256), (32, 1, 64)]
    for rows in (8 * 8 * 1024, 8 * 128 * 8, 64):
        x = torch.randn((rows, d), generator=gen, device="cuda").bfloat16()
        x = x * torch.rand((rows, 1), generator=gen, device="cuda") * 8
        x = x.bfloat16()
        pq, ps = kq.kv_quantize_plain(x)
        q, s_ = torch.empty_like(pq), torch.empty_like(ps)
        chosen = kq.kv_quant_plan(rows, d, 2, n_sm)
        calls = {}
        for p in [chosen] + [p for p in others if p != chosen]:
            arg = kq._plan_arg(p)
            calls[f"plan {p}" + (" (chosen)" if p == chosen else "")] = (
                lambda arg=arg: quant(x.data_ptr(), q.data_ptr(),
                                      s_.data_ptr(), rows, d, 1, arg, stream))
        for name, fn in texts.items():
            arg = kq._plan_arg(chosen)
            calls[f"{name}, chosen plan"] = (
                lambda fn=fn, arg=arg: fn(x.data_ptr(), q.data_ptr(),
                                          s_.data_ptr(), rows, d, 1, arg,
                                          stream))
        calls["warp_row (earlier design)"] = lambda: old(
            x.data_ptr(), q.data_ptr(), s_.data_ptr(), rows, d, 1, stream)
        bound = cs.quant_bound_ms(rows, d, 2, 1, "H100")[0]
        for rnd in range(2):
            print(f"B2 quantize {rows} x {d} round {rnd} bound {bound}: "
                  f"x.clone() ms {cs.time_ms(x.clone, flush)}, with a read "
                  f"flush {cs.time_ms(x.clone, read_flush)}", flush=True)
            for name, call in calls.items():
                q.zero_()
                assert call() == 0
                torch.cuda.synchronize()
                same = torch.equal(q, pq) and torch.equal(s_, ps)
                print(f"B2 quantize {rows} x {d} round {rnd} {name}: ms "
                      f"{cs.time_ms(call, flush)}, bit-equal {same}",
                      flush=True)
        del x, q, s_, pq, ps

    for layout in ("dense", "paged chunk"):
        k, v, leaves, dst, route_write = cs.make_store_case(gen, layout)
        n = k.numel() // d
        twin = {name: t.clone() for name, t in leaves.items()}
        kq.kv_quantize_store_plain(k, v, twin["k"], twin["v"],
                                   twin["k_scale"], twin["v_scale"], dst)
        chosen = kq.kv_quant_plan(2 * n, d, 2, n_sm)
        ptrs = [t.data_ptr() for t in (k, v, leaves["k"], leaves["v"],
                                       leaves["k_scale"], leaves["v_scale"],
                                       dst)]
        n_dst = leaves["k"].numel() // d
        calls = {}
        for p in [chosen] + [p for p in others if p != chosen]:
            arg = kq._plan_arg(p)
            calls[f"plan {p}" + (" (chosen)" if p == chosen else "")] = (
                lambda arg=arg: store(*ptrs, n, n_dst, d, 1, arg, stream))
        kk, vv = k.reshape(-1, d), v.reshape(-1, d)
        qk, qv = (torch.empty((n, d), dtype=torch.int8, device="cuda")
                  for _ in range(2))
        sk, sv = (torch.empty((n, 1), dtype=torch.bfloat16, device="cuda")
                  for _ in range(2))
        start = {name: t.clone() for name, t in leaves.items()}

        def separate_route():
            old(kk.data_ptr(), qk.data_ptr(), sk.data_ptr(), n, d, 1, stream)
            old(vv.data_ptr(), qv.data_ptr(), sv.data_ptr(), n, d, 1, stream)
            route_write(leaves, {"k": qk.view(k.shape), "v": qv.view(v.shape),
                                 "k_scale": sk.view(k.shape[:-1] + (1,)),
                                 "v_scale": sv.view(v.shape[:-1] + (1,))})
            return 0

        calls["warp_row + index_put_ (separate route)"] = separate_route
        bound = cs.store_bound_ms(n, int((dst >= 0).sum()), d, 2, "H100")[0]
        for rnd in range(2):
            for name, call in calls.items():
                for name_, t in leaves.items():
                    t.copy_(start[name_])
                assert call() == 0
                torch.cuda.synchronize()
                same = all(torch.equal(leaves[x], twin[x]) for x in leaves)
                print(f"B2 store {layout} ({n} rows each) round {rnd} bound "
                      f"{bound} {name}: ms {cs.time_ms(call, flush)}, "
                      f"bit-equal {same}", flush=True)
        del k, v, leaves, twin, dst


def main():
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    runs = {"b5": run_b5, "b1": run_b1, "b7": run_b7, "b3": run_b3,
            "b6": run_b6, "b4": run_b4, "b2": run_b2}
    for name in sys.argv[1:] or list(runs):
        runs[name](gen, flush, stream)
    return 0


if __name__ == "__main__":
    sys.exit(main())
