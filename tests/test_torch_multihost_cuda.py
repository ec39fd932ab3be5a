"""The sharded flagship's dry run on the cards, over NCCL.

Needs an NVIDIA GPU; skips without a card.  Imports no JAX, so on a
machine without it run it as

    python -m pytest tests/test_torch_multihost_cuda.py -q --noconftest

One NCCL process per card present, the reference's mesh rule (one card:
(1, 1); four: (2, 2)), the dry run's tiny shapes; the sharded audio
within 1e-4 of the unsharded pipeline on its last block (the bound
`dryrun_multichip` asserts, as the reference's).
"""

import pytest

torch = pytest.importorskip("torch")

from sdrtpu_torch.shard.multihost import dryrun_multichip  # noqa: E402


@pytest.mark.cuda
def test_dryrun_multichip_on_the_cards(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL ranks run on cards")
    n = torch.cuda.device_count()
    res = dryrun_multichip(n, device="cuda", workdir=tmp_path)
    assert res["audio_shape"] == [2, 8, 48]
    assert res["max_abs_err"] < 1e-4
