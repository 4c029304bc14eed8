"""The port's standalone L0 modules against the JAX package's, on the
inputs of JAX's own tests.

Each JAX test below runs as it is, with every function of the JAX module
it calls replaced by a pair: the JAX function and the port's copy take the
same (deep-copied) arguments, their results must be equal (arrays with
dtypes and shapes, dataclasses field by field, NaN equal to NaN) and an
exception in one must be raised by the other. The JAX test's own asserts
then hold the shared result. Modules: ``static_info``, ``cxr_catalog``,
``demographics``, ``preprocess``, ``subtype``, ``prompts``, ``reports``
and ``text_embeddings``; ``embed_reports`` runs a tiny ``transformers``
BERT built here, on the CPU, in both packages."""
import copy
import dataclasses
import importlib
import inspect
import types

import numpy as np
import pytest

MODULES = ("static_info", "cxr_catalog", "demographics", "preprocess",
           "subtype", "prompts", "reports", "text_embeddings")
JAX = "multimodal_edema_prediction_tpu.data."
PORT = "multimodal_edema_prediction_tpu_torch.data."
# the JAX test modules, and which of their tests call the L0 modules
TESTS = {"test_static_info": None, "test_preprocess": None,
         "test_subtype": None, "test_prompts": None, "test_reports": None,
         "test_l0_semantics": ("TestCxrCatalog", "TestDemographics"),
         "test_text_embeddings": ("test_clean_radiology_report",
                                  "test_join_text_flag")}


def assert_same(want, got, where="result"):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert want.dtype == got.dtype and want.shape == got.shape, \
            (where, want.dtype, got.dtype, want.shape, got.shape)
        if want.dtype == object:
            for i, (a, b) in enumerate(zip(want.ravel(), got.ravel())):
                assert_same(a, b, f"{where}[{i}]")
        else:
            np.testing.assert_array_equal(want, got, err_msg=where)
    elif dataclasses.is_dataclass(want) and not isinstance(want, type):
        assert type(want).__name__ == type(got).__name__, where
        for f in dataclasses.fields(want):
            assert_same(getattr(want, f.name), getattr(got, f.name),
                        f"{where}.{f.name}")
    elif isinstance(want, dict):
        assert list(want) == list(got), where
        for k in want:
            assert_same(want[k], got[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(want) is type(got) and len(want) == len(got), where
        for i, (a, b) in enumerate(zip(want, got)):
            assert_same(a, b, f"{where}[{i}]")
    elif isinstance(want, float) and want != want:
        assert isinstance(got, float) and got != got, where
    elif isinstance(want, np.datetime64) and np.isnat(want):
        assert isinstance(got, np.datetime64) and np.isnat(got), where
        assert want.dtype == got.dtype, where
    else:
        assert type(want) is type(got) and want == got, (where, want, got)


def _pair(jax_fn, port_fn, calls):
    def both(*args, **kwargs):
        again = copy.deepcopy((args, kwargs))
        try:
            want = jax_fn(*args, **kwargs)
        except Exception as e:
            with pytest.raises(type(e)):
                port_fn(*again[0], **again[1])
            raise
        got = port_fn(*again[0], **again[1])
        assert_same(want, got, jax_fn.__name__)
        calls.append(jax_fn.__name__)
        return want
    return both


def _paired_module(jax_mod, port_mod, calls):
    ns = types.SimpleNamespace()
    for name, obj in vars(jax_mod).items():
        if inspect.isfunction(obj) and obj.__module__ == jax_mod.__name__:
            obj = _pair(obj, getattr(port_mod, name), calls)
        setattr(ns, name, obj)
    return ns


def _cases():
    out = []
    for mod_name, only in TESTS.items():
        mod = importlib.import_module(mod_name)
        for name, obj in vars(mod).items():
            if only is not None and name not in only:
                continue
            if inspect.isclass(obj) and name.startswith("Test"):
                out += [(mod_name, f"{name}.{m}", None)
                        for m in vars(obj) if m.startswith("test_")]
            elif inspect.isfunction(obj) and name.startswith("test_"):
                marks = [m for m in getattr(obj, "pytestmark", [])
                         if m.name == "parametrize"]
                if marks:
                    argnames, values = marks[0].args[:2]
                    out += [(mod_name, name, (argnames, v)) for v in values]
                else:
                    out += [(mod_name, name, None)]
    return out


CASES = _cases()


@pytest.mark.parametrize("mod_name,test,params", CASES, ids=[
    f"{m}::{t}[{i}]" for i, (m, t, _) in enumerate(CASES)])
def test_port_module_equals_jax_on_jax_tests(mod_name, test, params,
                                             monkeypatch, tmp_path):
    mod = importlib.import_module(mod_name)
    calls = []
    for name in MODULES:
        jax_mod = importlib.import_module(JAX + name)
        port_mod = importlib.import_module(PORT + name)
        for attr, obj in list(vars(mod).items()):
            if obj is jax_mod:
                monkeypatch.setattr(mod, attr, _paired_module(
                    jax_mod, port_mod, calls))
            elif inspect.isfunction(obj) and \
                    obj.__module__ == jax_mod.__name__:
                monkeypatch.setattr(mod, attr, _pair(
                    obj, getattr(port_mod, obj.__name__), calls))
    if "." in test:
        cls, meth = test.split(".")
        fn = getattr(getattr(mod, cls)(), meth)
    else:
        fn = getattr(mod, test)
    kwargs = {}
    if params is not None:
        names = [n.strip() for n in params[0].split(",")] \
            if isinstance(params[0], str) else list(params[0])
        vals = params[1] if len(names) > 1 else (params[1],)
        kwargs = dict(zip(names, vals))
    if "tmp_path" in inspect.signature(fn).parameters:
        kwargs["tmp_path"] = tmp_path
    fn(**kwargs)
    assert calls, f"{mod_name}::{test} called no L0 function"


@pytest.fixture(scope="module")
def tiny_bert(tmp_path_factory):
    from transformers import BertConfig, BertModel, BertTokenizerFast
    import torch
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "edema", "mild",
             "severe", "clear", "lungs", "effusion", "no", "findings", "."]
    p = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    p.write_text("\n".join(vocab))
    tok = BertTokenizerFast(vocab_file=str(p), do_lower_case=True)
    cfg = BertConfig(vocab_size=len(vocab), hidden_size=32,
                     num_hidden_layers=1, num_attention_heads=2,
                     intermediate_size=37, max_position_embeddings=128)
    torch.manual_seed(0)
    return tok, BertModel(cfg)


@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_embed_reports_equals_jax(tiny_bert, pooling):
    """The same tokenizer and encoder, both packages' ``embed_reports``:
    within 1e-6 (the port runs the encoder on the device it is asked for,
    here the CPU)."""
    from multimodal_edema_prediction_tpu.data import text_embeddings as J
    from multimodal_edema_prediction_tpu_torch.data import \
        text_embeddings as P
    tok, model = tiny_bert
    texts = ["mild edema .", "no findings .", "severe effusion .",
             "clear lungs .", "FINDINGS:\n mild ==== edema"]
    want = J.embed_reports(texts, tok, model, batch_size=3, pooling=pooling)
    got = P.embed_reports(texts, tok, model, batch_size=3, pooling=pooling,
                          device="cpu")
    assert got.shape == want.shape == (5, 32) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_embed_reports_defaults_to_the_card(tiny_bert):
    import torch
    from multimodal_edema_prediction_tpu_torch.data import \
        text_embeddings as P
    tok, model = tiny_bert
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.embed_reports(["mild edema ."], tok, model)
