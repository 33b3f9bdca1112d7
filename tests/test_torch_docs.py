"""``docs/pt_api.md``, the port's counterpart of ``docs/api.md``, runs.

Every fenced ``python`` block runs in order, in one namespace, on the CPU:
the document's first block picks the device in one line
(``DEVICE = None``, the card), which the test swaps for ``"cpu"``.  Every
``repro_torch.…`` dotted name the document cites imports, its sections are
the reference document's in the reference's order, and it states no TPU
term.
"""
import importlib
import os
import re

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DOC = os.path.join(ROOT, "docs", "pt_api.md")
DEVICE_LINE = re.compile(r"^DEVICE = None\b.*$", re.M)


def _read(name):
    with open(os.path.join(ROOT, "docs", name)) as f:
        return f.read()


def _blocks(text):
    return re.findall(r"^```python\n(.*?)^```", text, re.S | re.M)


def test_doc_blocks_run_in_order_on_the_cpu(capsys):
    blocks = _blocks(_read("pt_api.md"))
    assert len(blocks) >= 7
    first, n = DEVICE_LINE.subn('DEVICE = "cpu"', blocks[0], count=1)
    assert n == 1, "the first block must set the device in one line: DEVICE = None"
    namespace = {"__name__": "pt_api_doc"}
    for i, block in enumerate([first] + blocks[1:]):
        exec(compile(block, f"{DOC}:block{i}", "exec"), namespace)  # noqa: S102
    assert namespace["DEVICE"] == "cpu" and not os.path.exists(namespace["work"])
    # the obs block prints a span tree with the sample's structure
    out = capsys.readouterr().out
    assert "execute [" in out and "plan [" in out and "memo=hit" in out
    assert "backend=tiled_fused predicted_words=10624.0" in out and "measured_words=10240" in out


def _resolve(dotted):
    parts = dotted.split(".")
    for cut in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:cut]))
        except ModuleNotFoundError:
            continue
        for attr in parts[cut:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(dotted)


CITED = sorted(set(re.findall(r"repro_torch(?:\.\w+)+(?![\w*])", _read("pt_api.md"))))


def test_doc_cites_enough_names():
    assert len(CITED) >= 20


@pytest.mark.parametrize("dotted", CITED)
def test_cited_name_imports(dotted):
    assert _resolve(dotted) is not None


def _sections(text):
    return [h.split(" (")[0] for h in re.findall(r"^## (.+)$", text, re.M)]


def test_sections_are_the_reference_sections_in_order():
    port, ref = _read("pt_api.md"), _read("api.md")
    assert _sections(port) == _sections(ref)
    assert _sections(port)[0] == "Query language" and _sections(port)[-1] == \
        "Compiled-circuit cache"
    assert len(re.findall(r"^#{1,2} ", port, re.M)) == len(re.findall(r"^#{1,2} ", ref, re.M))


def test_doc_states_no_tpu_term():
    hit = re.search(r"TPU|VMEM|Pallas|\bv5e\b|\b197e12\b|\b819e9\b|197 TF|819 GB", _read("pt_api.md"))
    assert hit is None, hit.group(0)
