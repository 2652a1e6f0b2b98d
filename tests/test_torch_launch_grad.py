"""The port's counted FLOPs of the ten reduced configs' loss and
gradients held to the JAX package's HLO count of ``jax.value_and_grad``
of its loss (``tests/_torch_launch.py``: B 2, S 64, f32, the reference
with ``use_kernels=False`` and the port on its converted weights).
"""
import pytest

from repro_torch.configs import base as PC

from _torch_launch import counts

ARCHS = PC.all_archs()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_flops_within_three_percent(arch):
    """Loss and gradients (remat per superblock) within 3%, equal for the
    dense configs and whisper.  Where they differ, by output size of the
    products:

    * kimi-k2 +65 536 (+0.08%): the gradient of the MoE combine
      ``einsum("tkd,tk->td")`` in ``picked`` is an outer product
      (contraction size 1); torch runs it as a ``bmm`` of 2 * T * k * D
      FLOPs, XLA as a broadcast multiply, which counts none.
    * arctic +131 072 (+0.13%): the same outer product, and the combine's
      forward that torch's ``checkpoint`` reruns in the backward pass,
      where XLA's remat drops it as dead (nothing downstream needs it).
    * jamba -1 159 168 (-0.32%): the reference's compiled step has more
      dot FLOPs in mamba's chunk products (outputs of 32, 256, 2 048 and
      4 096 elements: 28 672 and 458 752 each), less the MoE terms
      above.
    * xlstm -6 627 328 (-2.02%): the reference's sLSTM ``custom_vjp``
      recomputes each step's recurrent product h W_rec in its backward
      pass (4 194 304 FLOPs), where the port's ``SLSTMScan`` saves the
      gate pre-activations in its forward; the rest is in the mLSTM's
      chunk products (its three-operand einsums and their gradients)."""
    ref, port = counts(arch, "train")
    assert abs(port - ref) <= 0.03 * ref
