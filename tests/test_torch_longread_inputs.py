"""The long-read stage gate's inputs: tests/torch_cases.py longread_reads,
from the port's simulator and canu_tpu's, hash as
canu_tpu_torch/longread_overlap_reference.json records them
(scripts/torch_longread_reference.py made it with canu_tpu's; chip_smoke.py
phase 17 holds the port's cor stage on the card to it)."""

from __future__ import annotations

import json
import os

import pytest

from canu_tpu.sim import simulate as jax_sim
from canu_tpu_torch.sim import simulate as torch_sim
from torch_cases import LONG_READ_W, longread_reads, one_torch_thread, readset_digest  # noqa: F401

REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "canu_tpu_torch",
                   "longread_overlap_reference.json")


@pytest.mark.parametrize("sim", [torch_sim, jax_sim], ids=["port", "canu_tpu"])
def test_longread_inputs_hash_as_recorded(sim):
    with open(REF) as fh:
        ref = json.load(fh)
    rs = longread_reads(sim)
    assert readset_digest(rs) == ref["reads_sha256"]
    assert (rs.n_reads, int(rs.total_bases), int(rs.length.max())) == (
        ref["n_reads"], ref["total_bases"], ref["max_len"])
    # every read above 131,072 bases: the index is LONG_READ_W words wide
    assert int(rs.length.min()) > 8 * LONG_READ_W
    assert ref["rows"] > 0 and ref["n_candidates"] > 0
