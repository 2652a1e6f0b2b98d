"""The port's ``launch/`` (``src/repro_torch/launch/``) held to the JAX
package's ``repro.launch`` on the CPU: the ``Costs`` record and the
roofline arithmetic, the counter's rules (trip counts, the attention
kernels at their boundary in place of the panel discount) on the twins of
tests/test_substrate.py's HLO tests, the ``meta`` count against the CPU
count of every reduced config, the dry run's cells, model FLOPs, memory
and CLI, and the device table.  The FLOP counts of the reduced configs against the reference's
compiled steps are in tests/test_torch_launch_flops.py.
"""
import json
import math
import time
from types import SimpleNamespace

import pytest
import torch

from repro.configs import base as RC
from repro.launch import hlo_analysis as H
from repro.launch.mesh import make_host_mesh
from repro.models import build as ref_build
from repro.models.registry import param_stats as ref_param_stats
from repro_torch.configs import base as PC
from repro_torch.kernels import (KERNELS, flash_attention, paged_attention)
from repro_torch.launch import device as DV
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.models import build
from repro_torch.models.common import SAMPLING, fill, sampled
from repro_torch.train.trainer import make_train_step
from repro_torch.optim import OptConfig, Optimizer

from _torch_launch import plain_kernels

ARCHS = PC.all_archs()


# ------------------------------------------------------------ Costs, roofline
def _fill_costs(c):
    c.flops, c.hbm_bytes, c.hbm_bytes_raw, c.coll_bytes = 7e12, 3e10, 5e10, 2e9
    c.coll_by_kind["all-reduce"] += 2e9
    c.n_collectives["all-reduce"] += 3
    c.coll_by_shape["all-reduce f32[8]"] += 2e9
    c.hbm_by_shape["mm [4, 4]"] += 3e10
    return c


def _fields(c):
    return (c.flops, c.hbm_bytes, c.hbm_bytes_raw, c.coll_bytes,
            dict(c.coll_by_kind), dict(c.n_collectives),
            dict(c.coll_by_shape), dict(c.hbm_by_shape))


def test_costs_add_and_scaled_match_reference():
    """``Costs.scaled`` and ``Costs.add`` give the reference's fields."""
    a, b = _fill_costs(R.Costs()), _fill_costs(H.Costs())
    assert _fields(a.scaled(2.5)) == _fields(b.scaled(2.5))
    a.add(_fill_costs(R.Costs()).scaled(3))
    b.add(_fill_costs(H.Costs()).scaled(3))
    assert _fields(a) == _fields(b)


@pytest.mark.parametrize("peaks", [(989e12, 3.35e12, 450e9, 1),
                                   (197e12, 819e9, 50e9, 4)])
def test_roofline_matches_reference(peaks):
    """The same terms, keys and bottleneck as ``hlo_analysis.roofline`` on
    the same costs and peaks."""
    p, h, link, n = peaks
    for flops in (7e12, 1e6):
        a, b = _fill_costs(R.Costs()), _fill_costs(H.Costs())
        a.flops = b.flops = flops
        assert R.roofline(a, peak_flops=p, hbm_bw=h, link_bw=link,
                          links=n) == \
            H.roofline(b, peak_flops=p, hbm_bw=h, ici_bw=link, ici_links=n)


# --------------------------------------------------------- the counter rules
def _tanh_steps(w, x, loop):
    for _ in loop(9, x.device):
        x = torch.tanh(x @ w)
    return x.sum()


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_count_scan_equals_unroll(device):
    """The twin of ``test_hlo_analysis_scan_equals_unroll``: nine
    ``tanh(x @ w)`` steps count 9 * 2 * 32 * 128 * 128 FLOPs unrolled, and
    the trip-scaled body (one body run on meta, counted 9 times) counts
    the same FLOPs and bytes."""
    w = torch.ones(128, 128, device=device)
    x = torch.ones(32, 128, device=device)
    unrolled = R.count(_tanh_steps, w, x, lambda n, d: range(n))
    scanned = R.count(_tanh_steps, w, x, lambda n, d: sampled(range(n), d))
    assert unrolled.flops == 9 * 2 * 32 * 128 * 128
    assert _fields(scanned) == _fields(unrolled)


def test_sampled_runs_every_step_off_meta_and_under_autograd():
    """``sampled`` runs one body only on meta while a counter samples and
    no autograd graph crosses steps; ``fill`` pads the missing outputs."""
    meta = torch.device("meta")
    assert list(sampled(range(5), meta)) == [0, 1, 2, 3, 4]   # no counter
    SAMPLING[0] = True
    try:
        with torch.no_grad():
            assert list(sampled(range(5), torch.device("cpu"))) == \
                list(range(5))
            assert list(sampled(range(4, -1, -1), meta)) == [4]
        with torch.enable_grad():
            assert len(list(sampled(range(5), meta))) == 5
            assert list(sampled(range(5), meta, own_graph=True)) == [0]
    finally:
        SAMPLING[0] = False
    out = fill([torch.empty(2, 3, device=meta)], 4)
    assert len(out) == 4 and all(t.shape == (2, 3) for t in out)


def _flash(q, k, v, causal):
    return flash_attention(q, k, v, causal=causal)


def _paged(q, kc, vc, n):
    return paged_attention(q, kc, vc, n)


def _kernel_calls():
    """(name, fn, args, FLOPs, bytes) of one call of each attention
    kernel, its work counted by hand: flash_attention over a causal
    (256, 512) score panel, G = 4; paged_attention over 20 of its 32 page
    positions, G = 2."""
    q, k = torch.ones(1, 8, 256, 16), torch.ones(1, 2, 512, 16)
    pairs = sum(min(512, i + 256 + 1) for i in range(256))
    flash = ("flash_attention", _flash, (q, k, k, True),
             4 * 8 * 16 * pairs, 4 * (2 * q.numel() + 2 * k.numel()))
    qd, kc = torch.ones(2, 4, 16), torch.ones(4, 8, 2, 2, 16)
    paged = ("paged_attention", _paged, (qd, kc, kc, 20),
             4 * 2 * 4 * 16 * 20, 4 * (2 * qd.numel() + 2 * 2 * 2 * 20 * 16))
    return [flash, paged]


@pytest.mark.parametrize("which", [0, 1])
def test_count_kernel_boundary(which):
    """The twin of ``test_hlo_analysis_panel_discount``: a hand-written
    kernel counts at its boundary, so its plain version's score panel and
    f32 copies drop out of ``hbm_bytes`` while ``hbm_bytes_raw`` is
    unchanged; its FLOPs are the visible pairs' (or valid positions'), not
    the full score matrix's; with ``plain_kernels`` the plain version
    counts op by op in every field."""
    name, fn, args, flops, nbytes = _kernel_calls()[which]
    kern = R.count(fn, *args)
    with plain_kernels():
        plain = R.count(fn, *args)
    assert (kern.flops, kern.hbm_bytes) == (flops, nbytes)
    assert kern.hbm_bytes_raw == plain.hbm_bytes_raw == plain.hbm_bytes
    assert plain.hbm_bytes > 2 * nbytes and plain.flops > flops
    out = list(fn(*args).shape)
    assert dict(kern.hbm_by_shape) == {f"{name} {out}": nbytes}


def test_count_rules_views_gathers_scatters():
    """Views and allocations count nothing; a copy reads its source and
    writes its destination; a gather reads what it writes; a scatter
    touches its destination at its values' size; a broadcast operand
    counts its distinct elements."""
    x = torch.ones(64, 32)
    assert R.count(lambda: x.view(32, 64).t()[:4]).hbm_bytes_raw == 0
    assert R.count(lambda: torch.empty(1000)).hbm_bytes_raw == 0
    dst = torch.zeros(64, 32)
    assert R.count(lambda: dst[:8].copy_(x[:8])).hbm_bytes_raw == 2 * 8 * 32 * 4
    ids = torch.tensor([1, 5, 9])
    assert R.count(lambda: x[ids]).hbm_bytes_raw == \
        2 * 3 * 32 * 4 + 3 * 8
    vals = torch.ones(3, 32)
    assert R.count(lambda: dst.index_put_((ids,), vals, accumulate=True)
                   ).hbm_bytes_raw == 3 * 3 * 32 * 4 + 3 * 8
    row = torch.ones(32)
    assert R.count(lambda: x + row).hbm_bytes_raw == \
        (64 * 32 + 32 + 64 * 32) * 4


# ------------------------------------------------ meta against the CPU count
def _model_steps(arch, device):
    """(name, fn, args) of the reduced config's prefill, decode step and
    train step (2 microbatches) on ``device``, B 2, S 64, from zeros."""
    cfg = PC.reduced(PC.get(arch))
    model = build(cfg, device=device)
    params = model.init(0) if device == "cpu" else model.abstract_params()
    toks = torch.zeros(2, 64, dtype=torch.int64, device=device)
    frames = (torch.zeros(2, cfg.enc_seq, cfg.d_model, device=device)
              if cfg.enc_dec else None)
    cache = model.init_cache(2, 1024, prompt_len=63)
    opt = Optimizer(OptConfig())
    batch = {"tokens": toks, "labels": toks}
    if frames is not None:
        batch["frames"] = frames
    state = {"params": params, "opt": opt.init(params)}
    return [("prefill", model.prefill, (params, toks, frames)),
            ("decode", model.decode_step, (params, cache, toks[:, -1:])),
            ("train", make_train_step(model, opt, n_micro=2),
             (state, batch))]


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_count_equals_cpu_count(arch):
    """Every reduced config's prefill, decode step and train step counts
    the same FLOPs, ``hbm_bytes`` and ``hbm_bytes_raw`` on ``meta`` (where
    mamba's and the mLSTM's chunk loops, the sLSTM's forward and backward
    step loops and the microbatch loop run one body, scaled by the trip
    count) as on the CPU (where every body runs): the scaled count equals
    the full count."""
    cpu = _model_steps(arch, "cpu")
    meta = _model_steps(arch, "meta")
    for (name, f_c, a_c), (_, f_m, a_m) in zip(cpu, meta):
        with torch.no_grad():
            c = R.count(f_c, *a_c)
            m = R.count(f_m, *a_m)
        assert (c.flops, c.hbm_bytes, c.hbm_bytes_raw) == \
            (m.flops, m.hbm_bytes, m.hbm_bytes_raw), name
        assert c.flops > 0 and c.hbm_bytes > 0, name


def test_attention_wrappers_take_meta_tensors():
    """On meta both attention wrappers run their plain versions (shapes
    only) and launch nothing."""
    before = [k.launches for k in KERNELS]
    q = torch.empty(2, 4, 8, 16, device="meta")
    k = torch.empty(2, 2, 8, 16, device="meta")
    assert flash_attention(q, k, k).shape == (2, 4, 8, 16)
    kc = torch.empty(2, 4, 2, 2, 16, device="meta")
    out = paged_attention(torch.empty(2, 4, 16, device="meta"), kc, kc, 5)
    assert out.shape == (2, 4, 16) and out.device.type == "meta"
    assert [k.launches for k in KERNELS] == before


# ---------------------------------------------------------------- the dry run
def test_cells_equal_reference():
    """The 32 cells, in the reference's order."""
    got = [(c.arch_id, s.name) for c, s in PC.cells()]
    want = [(c.arch_id, s.name) for c, s in RC.cells()]
    assert got == want and len(got) == 32
    for cfg in map(PC.get, ARCHS):
        assert [(s.name, r) for s, r in cfg.skipped_shapes()] == \
            [(s.name, r) for s, r in RC.get(cfg.arch_id).skipped_shapes()]


@pytest.mark.parametrize("Sq,Skv,causal", [(32768, 32768, True),
                                            (7, 19, True), (19, 7, True),
                                            (1, 1500, False)])
def test_flash_work_counts_visible_pairs(Sq, Skv, causal):
    """``flash_attention``'s work: the pairs its bottom-right causal mask
    leaves visible (llama3-8b's 32k prompt, a query block behind a longer
    cache, more queries than keys), or every pair (whisper's one-query
    cross-attention), 4 * hd FLOPs a pair and query head."""
    from repro_torch.kernels.flash_attention.ops import visible_pairs, work
    if Sq * Skv < 10 ** 6:
        mask = torch.ones(Sq, Skv, dtype=torch.bool).tril(Skv - Sq)
        want = int(mask.sum()) if causal else Sq * Skv
    else:
        want = 536_887_296              # 32768 * 32769 / 2
    assert visible_pairs(Sq, Skv, causal) == want
    q = torch.empty(2, 8, Sq, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 2, Skv, 64, dtype=torch.bfloat16, device="meta")
    assert work(q, k, k, causal) == (
        4 * 2 * 8 * 64 * want, 2 * (2 * q.numel() + 2 * k.numel()))


@pytest.mark.parametrize("arch,shape", [("llama3-8b", "train_4k"),
                                        ("kimi-k2-1t-a32b", "decode_32k"),
                                        ("whisper-medium", "prefill_32k")])
def test_model_flops_by_reference_formula(arch, shape):
    """``model_flops`` is the reference's 6 N D (train) or 2 N D, N its
    ``param_stats``' active non-embedding count (dryrun.py:160-171), and
    ``useful_flops_ratio`` = model_flops / counted FLOPs."""
    s = {x.name: x for x in RC.ALL_SHAPES}[shape]
    ref = ref_build(RC.get(arch), make_host_mesh((1, 1), ("data", "model")))
    N = ref_param_stats(ref)["active_non_embed"]
    D_ = s.global_batch * (s.seq_len if s.kind in ("train", "prefill")
                           else 1)
    want = (6 if s.kind == "train" else 2) * N * D_
    stats = D.param_stats(build(PC.get(arch), device="meta"))
    got = D.model_flops(stats, s.kind, s.global_batch, s.seq_len)
    assert got == pytest.approx(want, rel=1e-12)
    res = D.run_cell(arch, shape, spec=DV.H100_SXM5_80GB)
    assert res["model_flops"] == got
    assert res["useful_flops_ratio"] == got / res["roofline"]["flops"]


def _arg_bytes(tree):
    return sum(t.numel() * t.element_size() for t in R.tensors_of(tree))


@pytest.mark.parametrize("arch,shape", [("llama3-8b", "prefill_32k"),
                                        ("xlstm-350m", "long_500k")])
def test_run_cell_full_size_on_meta(arch, shape):
    """A full-size cell counts on meta in under 60 s: its argument bytes
    are the parameters at their dtypes, plus the cache, plus the token
    inputs (the prompt, or one token a row in decode); the roofline is at
    the H100's data-sheet peaks."""
    t0 = time.perf_counter()
    res = D.run_cell(arch, shape, spec=DV.H100_SXM5_80GB)
    assert time.perf_counter() - t0 < 60
    cfg = PC.get(arch)
    s = {x.name: x for x in PC.ALL_SHAPES}[shape]
    model = build(cfg, device="meta")
    params = _arg_bytes(model.abstract_params())
    tokens = s.global_batch * (s.seq_len if s.kind == "prefill" else 1) * 8
    cache = (_arg_bytes(model.init_cache(s.global_batch, s.seq_len)["layers"])
             if s.kind == "decode" else 0)
    mem = res["memory"]
    assert mem["param_floor_bytes"] == params
    assert mem["argument_bytes"] == params + cache + tokens
    r = res["roofline"]
    assert r["t_compute"] == r["flops"] / 989e12
    assert r["t_memory"] == r["hbm_bytes"] / 3.35e12
    assert r["t_collective"] == 0 and res["n_chips"] == 1
    assert res["model_flops"] > 0 and 0 < res["useful_flops_ratio"] <= 1.5
    assert mem["fits_h100_80g"] == (mem["resident_bytes"] <= 80e9)
    if shape == "prefill_32k":
        # 2 N D (N also holds the norms' gains, which do no product, and
        # the head, which runs at the last position only) plus
        # flash_attention at its boundary: the causal prompt's visible
        # pairs, not the full score matrix
        B, S = s.global_batch, s.seq_len
        attn = 4 * B * cfg.n_heads * cfg.hd * S * (S + 1) // 2 * cfg.n_layers
        assert r["flops"] == pytest.approx(res["model_flops"] + attn,
                                           rel=1e-4)
        assert r["hbm_bytes"] < r["hbm_bytes_raw"]


def test_cli_writes_one_cell(tmp_path, capsys):
    """``main`` on one cell prints an OK line and writes its JSON."""
    D.main(["--arch", "smollm-360m", "--shape", "decode_32k", "--out",
            str(tmp_path)])
    out = capsys.readouterr().out
    assert out.startswith("OK   smollm-360m__decode_32k__h100")
    res = json.loads((tmp_path / "smollm-360m__decode_32k__h100.json")
                     .read_text())
    assert res["arch"] == "smollm-360m" and res["shape"] == "decode_32k"
    assert res["step"] == "serve_step" and res["device"] == "H100-SXM5-80GB"
    assert set(res["memory"]) >= {"argument_bytes", "output_bytes",
                                  "param_floor_bytes", "fits_h100_80g"}
    assert res["roofline"]["bottleneck"] == "memory"
    assert math.isclose(res["roofline"]["t_bound"],
                        res["roofline"]["t_memory"])


def test_cli_exits_1_on_a_failing_cell(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "no-such-arch", "--shape", "decode_32k", "--out",
                str(tmp_path), "--quiet"])
    assert e.value.code == 1
    assert "FAIL no-such-arch__decode_32k__h100" in capsys.readouterr().out


# -------------------------------------------------------------- device table
def test_device_spec_by_name():
    """The table's H100 SXM5 entry: NVIDIA's data-sheet peaks."""
    s = DV.device_spec("H100-SXM5-80GB")
    assert s is DV.H100_SXM5_80GB
    assert (s.peak_bf16_flops, s.hbm_bw, s.hbm_bytes, s.link_bw,
            s.sm_count) == (989e12, 3.35e12, 80e9, 450e9, 132)


def test_device_spec_raises_on_an_unknown_card(monkeypatch):
    """A card the table does not hold raises (no default), and so does a
    device that is neither a table entry nor CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for name, sms in (("NVIDIA A100-SXM4-80GB", 108),
                      ("NVIDIA H100 PCIe", 114)):
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda i, n=name, m=sms: SimpleNamespace(
                                name=n, multi_processor_count=m,
                                total_memory=80 * 2 ** 30))
        with pytest.raises(ValueError, match="no figures"):
            DV.device_spec()
    with pytest.raises(ValueError):
        DV.device_spec("cpu")
    with pytest.raises(ValueError):
        DV.device_spec("H200-SXM5-141GB")


def test_device_spec_reads_the_card(monkeypatch):
    """On an H100 SXM5 the entry comes back with the card's own memory
    size and power limit."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: SimpleNamespace(
                            name="NVIDIA H100 80GB HBM3",
                            multi_processor_count=132,
                            total_memory=85_024_112_640))
    monkeypatch.setattr(DV, "_power_limit", lambda i: "700.00 W")
    s = DV.device_spec()
    assert (s.name, s.card, s.power_limit, s.hbm_bytes) == \
        ("H100-SXM5-80GB", "NVIDIA H100 80GB HBM3", "700.00 W",
         85_024_112_640.0)
    assert s.peak_bf16_flops == 989e12 and s.hbm_bw == 3.35e12


def test_launch_imports_no_tpu_constant():
    """No TPU figure of the reference's mesh.py is in the port."""
    from pathlib import Path
    import repro_torch
    root = Path(repro_torch.__file__).parent
    text = "".join(p.read_text() for p in root.rglob("*.py"))
    for const in ("197e12", "819e9", "16e9", "ICI_BW"):
        assert const not in text, const


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "kimi-k2-1t-a32b",
                                  "whisper-medium"])
def test_meta_memo_changes_no_count(arch, monkeypatch):
    """The counter rebuilds a repeated meta op's outputs from its memo:
    every cost and every ``hbm_by_shape`` entry equals the count that
    runs every meta kernel."""
    def counts():
        out = []
        for _, f, a in _model_steps(arch, "meta"):
            with torch.no_grad():
                out.append(_fields(R.count(f, *a)))
        return out

    memo = counts()
    monkeypatch.setattr(R, "_meta_key", lambda *a: None)
    assert counts() == memo
