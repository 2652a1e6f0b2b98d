"""perfbench/count.py: hand-worked numbers at a tiny shape, the
configurations' published totals, and the FLOPs of the port's own
counter (``launch.dryrun.count_step``, each attention kernel counted at
its boundary) on the reduced dense configurations."""
import dataclasses
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import count as C  # noqa: E402

# 2 layers, d 8, 2 heads over 1 kv head of 4, d_ff 16, vocab 32
W = C.Widths(layers=2, d=8, heads=2, kv=1, hd=4, ff=16, vocab=32,
             qk_norm=True)


def test_tiny_shape_by_hand():
    # q 8x8, k 8x4, v 8x4, o 8x8, gate/up 8x16, down 16x8
    assert C.layer_matmul_params(W) == 64 + 32 + 32 + 64 + 3 * 128
    assert C.layer_norm_params(W) == 2 * 8 + 2 * 4
    assert C.visible_pairs(3, 3) == 6 and C.visible_pairs(2, 5) == 9
    # prefill of 2 rows x 3 tokens: 2*576*6*2 matmul, 4*2*4*6 pairs*2
    # rows*2 layers, head 2*8*32 per row
    p = C.prefill(W, 2, 3)
    assert p["flops"] == 2 * 576 * 6 * 2 + 4 * 2 * 4 * 12 * 2 + 2 * 8 * 32 * 2
    weights = 2 * (2 * (576 + 24) + 8 + 8 * 32)
    kv = 2 * 2 * 2 * 2 * 3 * 1 * 4            # elem, k+v, layers, rows, pos
    assert p["bytes"] == weights + 2 * 6 * 8 + 2 * kv + 4 * 2 * 32
    d = C.decode(W, 2, 5)
    assert d["flops"] == 2 * 576 * 2 * 2 + 4 * 2 * 4 * 5 * 2 * 2 + 2 * 8 * 32 * 2
    assert d["bytes"] == (weights + 2 * 2 * 8 + 2 * 2 * 2 * 2 * 5 * 4
                          + 2 * 2 * 2 * 2 * 1 * 4 + 4 * 2 * 32)
    f = C.flash_call(W, 2, 3)
    assert f == {"flops": 4 * 2 * 4 * 6 * 2,
                 "bytes": 2 * 2 * 3 * 4 * (2 * 2 + 2 * 1)}
    g = C.paged_call(W, 2, 5)
    assert g == {"flops": 4 * 2 * 4 * 5 * 2,
                 "bytes": 2 * 2 * 4 * (2 * 2 + 2 * 1 * 5)}
    assert C.bound_s({"flops": 989e12, "bytes": 1.0}, 989e12, 3.35e12) == 1.0
    assert C.bound_kind({"flops": 0.0, "bytes": 3.35e12}, 989e12,
                        3.35e12) == "memory"


@pytest.mark.parametrize("name,params", [("qwen3-32b", 32.76e9),
                                         ("mistral-large-123b", 31.25e9)])
def test_configuration_files_count_their_deployment(name, params):
    cfg = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                     .read_text())
    w = C.widths(cfg)
    n = (w.layers * (C.layer_matmul_params(w) + C.layer_norm_params(w))
         + w.d + 2 * w.d * w.vocab)
    assert abs(n / params - 1) < 0.005


@pytest.mark.parametrize("kind,batch,seq", [("prefill", 2, 64),
                                            ("prefill", 1, 96),
                                            ("decode", 2, 64),
                                            ("decode", 3, 40)])
@pytest.mark.parametrize("arch", ["qwen3-32b", "mistral-large-123b",
                                  "llama3-8b", "smollm-360m",
                                  "chameleon-34b"])
def test_flops_equal_the_port_counters_on_reduced_configs(arch, kind, batch,
                                                          seq):
    from repro_torch.configs import get, reduced
    from repro_torch.launch.dryrun import count_step
    cfg = dataclasses.replace(reduced(get(arch)), dtype="bfloat16")
    w = C.Widths(cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                 cfg.hd, cfg.d_ff, -(-cfg.vocab // 256) * 256, cfg.qk_norm)
    theirs = count_step(cfg, kind, batch, seq, max_len=128)["costs"].flops
    mine = (C.prefill(w, batch, seq) if kind == "prefill"
            else C.decode(w, batch, seq))["flops"]
    assert mine == theirs
