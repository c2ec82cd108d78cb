"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped (device cpu), the rest of a run driven,
each fault planted in the program's `_seed_resolved`.  A cell on one card
has no exchange between cards to leave out."""

import pytest

from benchmark.tests.conftest import WORKLOADS, run_tiny


def _state_unchanged(orig):
    """Every group gets the first stream the entry ever returned."""
    first = []

    def f(self, words, amb_r, amb_p, rlens, l_max, B):
        if not first:
            first.append(orig(self, words, amb_r, amb_p, rlens, l_max, B))
        return first[0].clone()

    return f


def _half_batch(orig):
    """The second half of every group left out (its reads never seeded)."""

    def f(self, words, amb_r, amb_p, rlens, l_max, B):
        r = rlens.clone()
        r[B // 2 :] = 0
        return orig(self, words, amb_r, amb_p, r, l_max, B)

    return f


def _altered_answer(orig):
    """One text position of every stream one off where it is produced."""

    def f(self, words, amb_r, amb_p, rlens, l_max, B):
        out = orig(self, words, amb_r, amb_p, rlens, l_max, B).clone()
        H = self._occ_budget(B, l_max)
        out[out.shape[0] - H] += 1  # the first occurrence's position
        return out

    return f


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _altered_answer],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_is_not_correct(workload, fault, cache_root, monkeypatch):
    from kart_tpu_torch.pipeline.mapper import TorchKartMapper

    monkeypatch.setattr(TorchKartMapper, "_seed_resolved", fault(TorchKartMapper._seed_resolved))
    r = run_tiny(workload, cache_root)
    assert r["correct"] is False
    assert r["compared"]["mismatched_reads"]["value"] > r["compared"]["mismatched_reads"]["limit"]


def test_unbroken_run_is_correct(cache_root):
    assert run_tiny("ecoli_pe.pe150", cache_root, seed=4)["correct"] is True
