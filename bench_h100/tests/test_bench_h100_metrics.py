"""The end-to-end reductions, the roofline reckoning and the kernel names."""

import json
import math
import os

import pytest

from conftest import BENCH, ROOT
from h100bench import endtoend as E
from h100bench.kernels import kernel_of
from h100bench.serve import Rec
from h100bench.traffic import Request
from h100bench.work import ModelWork, total


def _recs(n=40, gap=0.01, tokens=20, start=0.0, spacing=0.2):
    """n requests due every ``spacing`` s, each emitting ``tokens`` tokens
    ``gap`` s apart from 0.05 s after it is due."""
    out = []
    for i in range(n):
        due = start + i * spacing
        r = Rec(Request(i, [3], tokens), due=due)
        r.times = [due + 0.05 + j * gap for j in range(tokens)]
        out.append(r)
    return out


def test_rate_covers_the_whole_window():
    recs = _recs()
    assert E.output_tps(recs, 0.0, 4.0) == pytest.approx(
        sum(1 for r in recs for t in r.times if t <= 4.0) / 4.0)
    # a window past the last token: every token over all its seconds
    assert E.output_tps(recs, 0.0, 20.0) == pytest.approx(40 * 20 / 20.0)


def test_a_stall_moves_the_rate_and_the_tails():
    base = _recs()
    stalled = _recs()
    for r in stalled:  # a 50 ms stall every 150 ms: 1 gap in 15 crosses one
        r.due = r.due + 0.05 * math.floor(r.due / 0.15)
        r.times = [t + 0.05 * math.floor(t / 0.15) for t in r.times]
    t0, t1 = 0.0, 6.0
    assert E.output_tps(stalled, t0, t1) < E.output_tps(base, t0, t1)
    assert E.itl_p95_ms(base, t0, t1) == pytest.approx(10.0)
    assert E.itl_p95_ms(stalled, t0, t1) > 40.0
    for r in stalled[::2]:  # requests that wait for a stall to pass
        r.times = [t + 0.05 for t in r.times]
    assert E.ttft_p95_ms(stalled, t0, t1) > E.ttft_p95_ms(base, t0, t1)


def test_tails_cover_every_request_and_failures_sit_last():
    recs = _recs(n=40)
    ok = E.ttft_p95_ms(recs, 0.0, 8.0)
    assert ok == pytest.approx(50.0)
    recs[3].times = []  # never got a token
    recs[4].refused = True
    assert E.failed(recs, 0.0, 8.0) == 2
    assert E.ttft_p95_ms(recs, 0.0, 8.0) == E.FAILED_MS
    # a slow request counts: p95 of 40 lands between the two slowest
    slow = _recs(n=40)
    for r in slow[:3]:
        r.times = [t + 1.0 for t in r.times]
    assert E.ttft_p95_ms(slow, 0.0, 8.0) > 500.0


def test_quantile_matches_numpy():
    import numpy as np

    xs = [5.0, 1.0, 3.0, 9.0, 7.0, 2.0]
    for q in (0.25, 0.5, 0.95):
        assert E.quantile(xs, q) == pytest.approx(float(np.quantile(xs, q)))
    assert math.isinf(E.quantile([1.0, math.inf], 0.95))


def _cfg(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_mixtral_layer_reckoned_by_hand():
    from reference import mixtral

    w = ModelWork(_cfg("mixtral-8x7b-l2"), mixtral)
    # attention projections of one layer, Q4_K (144 B a 256 weights):
    # q and o 4096 x 4096, k and v 1024 x 4096
    attn = (2 * 4096 * 4096 + 2 * 1024 * 4096) * 144 // 256
    assert attn == 23_592_960
    assert sum(nb for _, _, nb in w.dense) == 2 * attn
    # one layer's experts: gate and up 8 x 14336 x 4096 Q4_K, down Q6_K
    per_expert = 2 * 14336 * 4096 * 144 // 256 + 4096 * 14336 * 210 // 256
    assert 8 * per_expert == 913_833_984
    assert sum(e * per for e, _, _, per in w.experts) == 2 * 8 * per_expert
    assert w.head == (4096, 32000, 32000 * 4096 * 210 // 256)
    # a decode step of 32 rows, each one token after 999 cached ones
    parts = w.step([(1, 999)] * 32, 32)
    flops_dense = 2 * 32 * (2 * 4096 * 4096 + 2 * 1024 * 4096) * 2
    assert parts["dense"].flops == flops_dense
    assert parts["experts"].flops == 2 * 64 * 3 * 4096 * 14336 * 2
    # attention: 32 x 1000 pairs, QK^T and PV over 32 heads of 128; K and V
    # of 8 heads, bf16, 999 read and 1 written a row, 2 layers
    assert parts["attention"].flops == 2 * 32 * 1000 * 32 * 256 * 2
    assert parts["attention"].nbytes == \
        2 * (32 * 1000 * 2 * 8 * 128 * 2 + 32 * 2 * 32 * 128 * 2)
    tot = total(parts)
    assert tot.binds == "bytes"
    # every expert's bytes dominate: the bound is about 0.64 ms
    assert 0.55e-3 < tot.bound_s < 0.75e-3


def test_moonlight_layer_reckoned_by_hand():
    from reference import deepseek2

    w = ModelWork(_cfg("moonlight-16b-a3b-l5"), deepseek2)
    # an MoE layer's experts: gate and up 64 x 1408 x 2048 Q4_K, down
    # 64 x 2048 x 1408 Q5_1 (24 B a 32 weights)
    gate = 1408 * 2048 * 144 // 256
    down = 2048 * 1408 * 24 // 32
    assert [per for *_, per in w.experts][:3] == [gate, gate, down]
    assert len(w.experts) == 3 * 4
    # MLA: q 3072 x 2048, kv_a 576 x 2048, o 2048 x 2048, all Q4_K;
    # W_kv_b 4096 x 512 counted with attention
    q_kva_o = (3072 * 2048 + 576 * 2048 + 2048 * 2048) * 144 // 256
    dense_ffn = 2 * 11264 * 2048 * 144 // 256 + 2048 * 11264 * 210 // 256
    shared = 2 * 2816 * 2048 * 144 // 256 + 2048 * 2816 * 210 // 256
    assert sum(nb for _, _, nb in w.dense) == 5 * q_kva_o + dense_ffn \
        + 4 * shared
    assert w.attn_dense == [(512, 4096, 4096 * 512 * 144 // 256)] * 5
    # a 512-token chunk at position 0: causal pairs 512 * 513 / 2
    parts = w.step([(512, 0)], 1)
    pairs = 512 * 513 // 2
    assert parts["attention"].flops == \
        5 * 2 * pairs * 16 * (192 + 128) + 2 * 512 * 512 * 4096 * 5
    assert parts["experts"].flops == 2 * 512 * 6 * 3 * 2048 * 1408 * 4


def test_kernel_names():
    assert kernel_of("void qgemm_tc<0, 1, 2, __nv_bfloat16, float, 0>"
                     "(float const*)") == 1
    assert kernel_of("void qgemm_splitk<1, 0, true, float, float, 0>(x)") == 2
    assert kernel_of("void qgemm_tc<0, 1, 2, float, float, 1>(x)") == 3
    assert kernel_of("void qgemm_splitk<0, 1, true, float, float, 4>(x)") == 4
    assert kernel_of("void qgemm_tc<0, 1, 2, float, float, 2>(x)") == 5
    assert kernel_of("void qgemm_tc<0, 1, 2, float, float, 3>(x)") == 6
    assert kernel_of("void moe_grouped_kernel<1, 2, true, float>(x)") == 6
    assert kernel_of("void moe_grouped_kernel<1, 1, true, float>(x)") == 5
    assert kernel_of("ampere_sgemm_128x64_nn") is None


def test_benchmark_json_names_existing_files():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           f"{w['traffic']}.json"))
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           f"{m['name']}.py"))
