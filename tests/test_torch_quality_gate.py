"""Port parity: the quantization quality gate (eval/quality_gate.py)
against the JAX package on the CPU.

Both packages train the byte-level proxy from one initial tree (the JAX
package's random_parameters, carried across) on the same corpus and
window draws, export it through write_ggjt, quantize the file and measure
held-out perplexity: every row within 1e-4 relative (three AdamW steps in
f32, then f32 sums in another order). Neither writes under
bench_artifacts/.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from llamago_tpu.checkpoint import params as jparams
from llamago_tpu.config import ModelConfig as JModelConfig
from llamago_tpu.eval import quality_gate as jgate
from llamago_tpu_torch.checkpoint import params
from llamago_tpu_torch.eval import quality_gate as gate

torch.set_num_threads(1)

PPL_RTOL = 1e-4
SMALL = dict(steps=3, dim=64, n_layers=2, ctx=32)
ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "bench_artifacts")


def _artifacts() -> dict:
    out = {}
    for name in sorted(os.listdir(ARTIFACTS)):
        p = os.path.join(ARTIFACTS, name)
        if os.path.isfile(p):
            with open(p, "rb") as f:
                out[name] = f.read()
    return out


def test_corpus_vocab_and_ids_equal_jax():
    assert gate._corpus() == jgate._corpus()
    assert [t for t in gate.byte_vocab().tokens] == [t for t in jgate.byte_vocab().tokens]
    text = gate._corpus()[1][:500]
    assert np.array_equal(gate._byte_ids(text), jgate._byte_ids(text))


@pytest.fixture(scope="module")
def both_gates(tmp_path_factory):
    before = _artifacts()
    jcfg = JModelConfig(vocab_size=259, dim=SMALL["dim"], n_layers=SMALL["n_layers"],
                        n_heads=4, multiple_of=32, max_seq_len=SMALL["ctx"],
                        dtype="float32", weight_dtype="float32")
    init = jparams.random_parameters(jcfg, seed=0)
    want = jgate.run_gate(**SMALL, tmp_dir=str(tmp_path_factory.mktemp("jax_gate")))
    got = gate.run_gate(**SMALL, device="cpu",
                        init=params.params_from_numpy(jax.tree.map(np.asarray, init),
                                                      device="cpu"))
    return want, got, before


def test_run_gate_rows_match_jax(both_gates):
    want, got, _ = both_gates
    assert "fused" not in got and "fused" not in want
    assert set(got["ppl"]) == set(want["ppl"]) == {"fp32", "q8_0", "q4_0", "q4_1", "kv_int8"}
    for k, w in want["ppl"].items():
        assert abs(got["ppl"][k] - w) <= PPL_RTOL * w, (k, got["ppl"][k], w)
    for k in ("metric", "model", "eval_tokens", "ctx", "train_steps", "baseline_gate"):
        assert got[k] == want[k]
    assert set(got["ppl_delta_vs_fp32"]) == set(want["ppl_delta_vs_fp32"])


def test_gate_writes_nothing_under_bench_artifacts(both_gates, capsys, tmp_path):
    """Neither run wrote there, and main prints its JSON to stdout and
    refuses an --out path under bench_artifacts/."""
    _, _, before = both_gates
    assert _artifacts() == before
    with pytest.raises(SystemExit):
        gate.main(["--device", "cpu", "--out", os.path.join(ARTIFACTS, "x.json")])
    assert _artifacts() == before
    capsys.readouterr()


def test_main_prints_one_json_line(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(gate, "run_gate", lambda **kw: {"metric": "quantization_ppl_gate",
                                                        "kw": sorted(kw)})
    out = str(tmp_path / "gate.json")
    assert gate.main(["--device", "cpu", "--steps", "2", "--out", out]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "quantization_ppl_gate" and line["backend"] == "cpu"
    assert "device" in line["kw"] and json.load(open(out)) == line
