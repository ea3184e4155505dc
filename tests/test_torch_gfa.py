"""The port's GFA output gives what canu_tpu's gives: align_links (the
alignGFA re-alignment on the Myers extension) and write_gfa with and
without verify_edges, on tests/test_gfa.py's cases and on links found
from an overlap store between tig end reads.  Exact, on the CPU."""

from __future__ import annotations

import pytest

import canu_tpu.io.gfa as JG
import canu_tpu.ops.align as JAL
import canu_tpu.stores.overlaps as JOV
import canu_tpu.stores.tigs as JT
import canu_tpu_torch.io.gfa as TG
import canu_tpu_torch.stores.tigs as TT
from torch_cases import GFA_STORE_ROWS, gfa_cases as _cases, gfa_store as _store, gfa_tigs as _tigs
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("case", range(3))
def test_align_links_equal(case):
    seqs, links = _cases()[case]
    want = JG.align_links(_tigs(JT, seqs), links, max_erate=0.1)
    got = TG.align_links(_tigs(TT, seqs), links, max_erate=0.1, device="cpu")
    assert got == want
    assert got and all(isinstance(x, float) for *_, x in got)


def test_write_gfa_equal(tmp_path):
    """tests/test_gfa.py's write_gfa case, and links from an overlap store:
    the end reads of tigs 1 and 2 dovetail (a true link), tig 3's end read
    overlaps tig 1's (a link the re-alignment drops)."""
    import canu_tpu_torch.ops.align as TAL
    import canu_tpu_torch.stores.overlaps as TOV

    seqs, _ = _cases()[0]
    rows = GFA_STORE_ROWS
    pages = {}
    for name, G, T, store in (("jax", JG, JT, _store(JAL, JOV, rows, 40)),
                              ("torch", TG, TT, _store(TAL, TOV, rows, 40))):
        kw = {} if name == "jax" else {"device": "cpu"}
        for verify in (False, True):
            for st in (None, store):
                p = str(tmp_path / f"{name}{verify}{st is None}.gfa")
                n = G.write_gfa(p, _tigs(T, seqs), None, store=st, verify_edges=verify, **kw)
                with open(p) as fh:
                    pages[name, verify, st is None] = (n, fh.read())
    for key in [k for k in pages if k[0] == "torch"]:
        assert pages[key] == pages[("jax",) + key[1:]], key
    body = pages["torch", True, False][1]
    assert body.count("\nS\t") == 3 and "\nL\ttig00000001" in body
