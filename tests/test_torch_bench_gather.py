"""The port's gather probe measures only on a card: without one it exits
non-zero and measures nothing."""

import pytest
import torch

from kart_tpu_torch.tools import bench_gather


def test_bench_gather_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as exc:
        bench_gather.main([])
    assert exc.value.code not in (0, None)
    assert "formulation" not in capsys.readouterr().out
