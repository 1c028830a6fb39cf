"""The plain reference against its own definition and against the port,
at tiny sizes on the CPU in float32.  The tolerances: the chunked SSD
and the port sum the same float32 terms in other orders, so they agree
to about 1e-6 of the values' scale, well inside 1e-4 and far below the
bfloat16 rounding (about 4e-3) the serving limit is set against."""
import dataclasses
import inspect

import pytest
import torch

from portbench.harness import weights
from portbench.reference import lm as ref


def test_reference_imports_nothing_of_the_program():
    src = inspect.getsource(ref)
    assert "repro" not in src.replace("repository", "")
    assert "jax" not in src


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunked_is_the_recurrence(g):
    gen = torch.Generator().manual_seed(0)
    b, s, h, p, n = 2, 37, 4, 3, 5
    x = torch.randn(b, s, h, p, generator=gen)
    dt = torch.rand(b, s, h, generator=gen) * 0.5
    A = -torch.linspace(1.0, 4.0, h)
    B = torch.randn(b, s, g, n, generator=gen)
    C = torch.randn(b, s, g, n, generator=gen)
    y0, st0 = ref.ssd_sequential(x, dt, A, B, C)
    for chunk in (1, 8, 16, 64):
        y, st = ref.ssd_chunked(x, dt, A, B, C, chunk)
        assert torch.allclose(y, y0, atol=1e-5, rtol=1e-5)
        assert torch.allclose(st, st0, atol=1e-5, rtol=1e-5)


def _tiny(module, **kw):
    import importlib
    base = importlib.import_module(f"repro_torch.configs.{module}").CONFIG
    return dataclasses.replace(base, param_dtype="float32",
                               compute_dtype="float32", **kw)


CFGS = {
    "ssm": lambda: _tiny("mamba2_780m", num_layers=3, d_model=32,
                         vocab_size=97, ssm_state=8, mamba_headdim=8,
                         ssd_chunk=16),
    "hybrid": lambda: _tiny("zamba2_1_2b", num_layers=4, d_model=32,
                            num_heads=4, num_kv_heads=2, head_dim=8,
                            d_ff=64, vocab_size=97, ssm_state=8,
                            mamba_headdim=8, attn_every=2, ssd_chunk=16),
}


@pytest.mark.parametrize("family", sorted(CFGS))
def test_reference_forward_is_the_ports_model(family):
    from repro_torch.models import transformer as T
    cfg = CFGS[family]()
    params = weights.init_params(weights.layout(cfg), 3,
                                 torch.device("cpu"))
    toks = torch.randint(0, cfg.vocab_size, (1, 45),
                         generator=torch.Generator().manual_seed(1))
    want, _, _ = T.forward(cfg, params, {"tokens": toks})
    got = ref.logits_at(ref.served_weights(params, 0), toks[0],
                        torch.arange(45), dataclasses.asdict(cfg))
    scale = want.abs().max()
    assert (got - want[0]).abs().max() <= 1e-4 * scale


def test_quantize_dequantize_is_the_ports_q15():
    from repro_torch.compress.tree import quantize_tree
    params = weights.init_params(weights.layout(CFGS["ssm"]()), 5,
                                 torch.device("cpu"))
    qt, sc = quantize_tree(params, 16)
    w = params["blocks"]["mamba"]["x_proj"]["w"]
    q = qt["blocks"]["mamba"]["x_proj"]["w"]
    s = sc["blocks"]["mamba"]["x_proj"]["w"]
    assert torch.equal(ref.quantize_dequantize(w, 16), q.float() * s)


def test_weights_follow_the_seed_and_the_ports_layout():
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg = CFGS["hybrid"]()
    lay, cpu = weights.layout(cfg), torch.device("cpu")
    a = weights.init_params(lay, 2**31 + 9, cpu)
    b = weights.init_params(lay, 2**31 + 9, cpu)
    c = weights.init_params(lay, 2**31 + 10, cpu)
    meta = dict(weights.leaves(T.init(cfg, L.SHAPE_ONLY)))
    la, lb, lc = (dict(weights.leaves(t)) for t in (a, b, c))
    assert la.keys() == meta.keys()
    for k, m in meta.items():
        assert la[k].shape == m.shape and la[k].dtype == m.dtype
        assert torch.equal(la[k], lb[k])
    assert not torch.equal(la[("embed", "table")], lc[("embed", "table")])


def test_each_config_files_layout_is_the_ports():
    from portbench.harness import manifest as mf
    man = mf.load()
    for c in man["configs"]:
        body = mf.config_file(mf.ROOT, man, c["name"])
        assert body["layout"] == weights.layout(mf.model_config(body))
