#!/usr/bin/env python3
"""Build one checkout's attention kernels and time them at llama3-8b's
serve shapes on the card.

    python3 tools/time_attention.py CHECKOUT

``CHECKOUT`` is the root of any checkout of this repository with
``src/repro_torch/csrc/{flash,paged}_attention.cu`` (this one, or an
older one unpacked beside it with ``git archive``).  The script puts that
checkout's ``src`` first on the path, builds its two attention libraries
into its own ``build/kernels/``, and prints one line to standard error:

    [attn] NAME: ptxas <registers and spills of each bf16 entry>;
    flash_attention D ms, paged_attention D ms on the device

``flash_attention``: q (4, 32, 1152, 128), k/v (4, 8, 1152, 128), bf16,
causal (the serve run's largest prefill).  ``paged_attention``: q
(4, 32, 128), pages (2, 1024, 4, 8, 128), bf16, valid_len 1167 (its
longest decode step), pages cold in L2 (6 copies in turn).  Inputs come
from a fixed seed, so two checkouts run in turns in one call on one card
(parent, change, change, parent) give comparable numbers.  The timing and
ptxas helpers are this tree's ``chip_smoke.py``'s.
"""
from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    tree = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(HERE))
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build, flash_attention, paged_attention
    if not torch.cuda.is_available():
        print("time_attention: no CUDA device", file=sys.stderr)
        return 2
    build.build_all(["flash_attention", "paged_attention"])
    ptx = [f"{k}: {info}" for n in ("flash_attention", "paged_attention")
           for k, info in cs.ptxas_report(build.build_log(n))
           if k.startswith(("flash_fwd_wgmma", "paged_split_mma"))]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = rnd(4, 32, 1152, 128), rnd(4, 8, 1152, 128), rnd(4, 8, 1152, 128)
    flash = cs.device_time_ms(lambda: flash_attention(q, k, v, causal=True),
                              iters=20)
    qd = rnd(4, 32, 128)
    pages = [(rnd(2, 1024, 4, 8, 128), rnd(2, 1024, 4, 8, 128))
             for _ in range(6)]
    turn = iter(range(1 << 62))

    def paged():
        kc, vc = pages[next(turn) % len(pages)]
        return paged_attention(qd, kc, vc, 1167)

    paged_ms = cs.device_time_ms(paged)
    print(f"[attn] {tree.name or tree}: ptxas {'; '.join(ptx)}; "
          f"flash_attention {flash:.5f} ms, paged_attention {paged_ms:.6f} "
          f"ms on the device", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
