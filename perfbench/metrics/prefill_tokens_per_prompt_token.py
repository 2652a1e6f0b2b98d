"""Tokens in every ``Model.prefill`` input of the window (rows x
positions, padding and re-prefilled tokens included) per prompt token
admitted: 1.0 when each prompt is prefilled once and nothing is padded;
below 1 only if a prefill skipped cached blocks.  A count.  Layer:
engine (``serving/engine.py``)."""


def _sums(run):
    pre = sum(s.attrs["batch"] * s.attrs["seq"]
              for s in run.spans.of("perfbench.prefill"))
    adm = sum(s.attrs.get("prompt_tokens", 0)
              for s in run.spans.of("perfbench.admit"))
    return pre, adm


def read(run):
    pre, adm = _sums(run)
    return pre / adm if adm else None


def explain(run):
    pre, adm = _sums(run)
    return f"{pre} prefill tokens / {adm} prompt tokens admitted"
