"""The comparison that decides ``correct`` fails what it has to fail: the
control (the reference in the program's place, below the stated precision)
and each fault a cell can have, planted in the program underneath a run
that skips only the look for a card."""
import pytest
import torch

import _bench
from bench import control

CELLS = _bench.cells()


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    res = _bench.tiny(cell, stand_in=control, seconds=4.0)
    assert res["attempted"] >= 16, "too few requests to reach every template"
    assert res["correct"] is False
    assert res["checks"]["mismatched_words"]["value"] > 0
    assert res["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced_is_caught(cell, monkeypatch):
    from repro_torch.query.index import BitmapIndex

    mask = BitmapIndex._mask

    def flipped(self, out):
        out = mask(self, out).clone()
        out.view(-1)[0] ^= 1
        return out

    monkeypatch.setattr(BitmapIndex, "_mask", flipped)
    res = _bench.tiny(cell)
    assert res["correct"] is False
    assert res["checks"]["wrong_answers"]["value"] == res["checks"]["checked_answers"]["value"]


def test_half_of_a_batch_left_out_is_caught(monkeypatch):
    from repro_torch.query.index import BitmapIndex

    many = BitmapIndex.execute_many

    def half(self, queries, **kw):
        qs = list(queries)
        keep = len(qs) // 2  # a batch of one loses its one answer
        outs = many(self, qs[:keep], **kw) if keep else []
        blank = torch.zeros(self.n_words, dtype=torch.int32, device=self.device)
        return outs + [blank.clone() for _ in qs[keep:]]

    monkeypatch.setattr(BitmapIndex, "execute_many", half)
    res = _bench.tiny("uniform64.served-adhoc", seconds=1.5)
    assert res["correct"] is False
    assert res["checks"]["wrong_answers"]["value"] > 0


def test_an_update_that_leaves_the_index_unchanged_is_caught(monkeypatch):
    from repro_torch.stream import StreamingIndex

    monkeypatch.setattr(StreamingIndex, "update", lambda self, sets=None, clears=None: None)
    res = _bench.tiny("clustered64.live-updates", seconds=1.5)
    assert res["correct"] is False
    assert res["checks"]["mismatched_words"]["value"] > 0
