"""FedHP on a registry LM under the reference's per-leaf codec map,
against the reference.

The tiny dense LM of ``tests/test_torch_registry_engine.py``
(``_torch_parity.TINY_LM``) trains at W = 8 for 5 rounds under
``leafmap:embed=randk:0.05,ln=none,default=int8`` — the map of the
reference's pytree benchmark leg (embeddings rand-k, layernorm scales
raw, every other leaf int8: on this LM six segments, three of them
int8) — through the reference JAX ``engine.run_dfl`` and the port's
``run_dfl`` and ``run_dfl_fused`` on the CPU, from the reference's
initialisation. FedHP closes its loop through the measurements, so its
plans (and every host field) come out equal only if the leafmap rounds
agree. The measurement stack makes a FedHP round cost seconds of one
core in each package, so this file holds this case alone; D-PSGD on the
LM is in ``tests/test_torch_leafmap_engine.py``.

Host fields exactly equal; the map has int8 segments, so loss is held
to 2e-3 and consensus to 1e-2 relative (int8's tolerances,
``tests/test_torch_codec_engine.py``), accuracy to 1/512.
"""
from __future__ import annotations

from _torch_parity import (TINY_LM, assert_parity, run_port, run_reference,
                           worst_diffs)

ROUNDS = 5
LM_MAP = "leafmap:embed=randk:0.05,ln=none,default=int8"


def test_fedhp_engines_match_reference_on_the_lm():
    h_ref, _ = run_reference("fedhp", False, ROUNDS, model=TINY_LM,
                             compress=LM_MAP)
    for engine_name in ("reference", "fused"):
        h_port = run_port("fedhp", False, engine_name, rounds=ROUNDS,
                          model=TINY_LM, compress=LM_MAP)
        print(f"[{engine_name}] worst differences:",
              worst_diffs(h_ref.as_arrays(), h_port.as_arrays()))
        assert_parity(h_ref, h_port, ROUNDS, int8=True)
