"""The port on several cards, as far as the CPU can hold it.

A kernel's library entry makes the card of its tensors current
(``cudaSetDevice``) and a thread keeps its current card, so each wrapper
calls it under ``torch.cuda.device`` of that tensor, which gives the
caller's card back: a source check holds every call into the libraries to
that. ``scripts/mesh_cards.py`` runs every mesh path on one shard per card;
here its host logic: it refuses to run without a card or with an unknown
check, and it reads a profiler trace's kernels by card, copies by kind and
their time by card.
"""

import ast
import importlib
import pathlib

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
KERNELS = REPO / "syllable_detector_tpu_torch" / "kernels"


def library_calls(tree: ast.AST, entry: str) -> list[tuple[ast.Call, list[ast.With]]]:
    """Each call of ``<something>.<entry>(...)`` in ``tree`` with the
    ``with`` statements around it, innermost first."""
    found = []

    def visit(node, withs):
        if isinstance(node, ast.With):
            withs = [node, *withs]
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == entry):
            found.append((node, withs))
        for child in ast.iter_child_nodes(node):
            visit(child, withs)

    visit(tree, [])
    return found


def guarded_by(call: ast.Call, withs: list[ast.With]) -> set[str]:
    """The names ``x`` of the ``torch.cuda.device(x.device)`` guards around
    ``call`` whose ``x`` the call passes on."""
    passed = {n.id for arg in call.args for n in ast.walk(arg) if isinstance(n, ast.Name)}
    names = set()
    for node in withs:
        for item in node.items:
            e = item.context_expr
            if (isinstance(e, ast.Call) and ast.unparse(e.func) == "torch.cuda.device"
                    and len(e.args) == 1 and isinstance(e.args[0], ast.Attribute)
                    and e.args[0].attr == "device" and isinstance(e.args[0].value, ast.Name)
                    and e.args[0].value.id in passed):
                names.add(e.args[0].value.id)
    return names


@pytest.mark.parametrize("module, entry", [
    ("fused_detector.py", "sd_fused_detector"),
    ("framed_gemm.py", "sd_framed_gemm"),
    ("peer_exchange.py", "sd_peer_push"),
    ("peer_exchange.py", "sd_peer_wait"),
])
def test_kernel_library_calls_run_under_their_tensors_device(module, entry):
    """Every call into a kernel's library is made under
    ``torch.cuda.device`` of a tensor it passes, so that the card current
    before the call is current after it."""
    calls = library_calls(ast.parse((KERNELS / module).read_text()), entry)
    assert calls, f"no call of {entry} in {module}"
    for call, withs in calls:
        assert guarded_by(call, withs), (
            f"{module}:{call.lineno}: {entry} is not called under torch.cuda.device "
            "of a tensor it passes")


def test_guard_check_tells_guarded_from_unguarded_calls():
    """The source check above on small sources: a guard of a tensor the call
    passes counts, a guard of another tensor or another context does not."""
    def names(src):
        (call, withs), = library_calls(ast.parse(src), "sd_k")
        return guarded_by(call, withs)

    assert names("with torch.cuda.device(x.device):\n    lib.sd_k(f(x), 1)\n") == {"x"}
    assert names("with a, torch.cuda.device(xs.device):\n    lib.sd_k(xs.data_ptr())\n") == {"xs"}
    assert not names("lib.sd_k(x)\n")
    assert not names("with torch.cuda.device(y.device):\n    lib.sd_k(x)\n")
    assert not names("with torch.cuda.stream(x.device):\n    lib.sd_k(x)\n")
    assert not names("with torch.cuda.device(x):\n    lib.sd_k(x)\n")


@pytest.fixture(scope="module")
def mesh_cards():
    return importlib.import_module("scripts.mesh_cards")


def test_mesh_cards_needs_a_card(mesh_cards, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mesh_cards.main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_mesh_cards_refuses_an_unknown_check(mesh_cards, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert mesh_cards.main(["device", "halo"]) == 2
    assert "unknown checks ['halo']" in capsys.readouterr().err
    assert list(mesh_cards.CHECKS) == ["device", "corpus", "fused", "offline", "counts",
                                       "tensor", "time", "stream", "train"]


def test_mesh_cards_reads_kernels_by_card_and_copies_by_kind(mesh_cards):
    """A chrome trace's kernels counted per card (all, or those whose name
    holds the kernel's), its copies summed per kind (a copy between cards
    by its two cards, as the trace names them), the time of both per card;
    other events are ignored."""
    k1 = "void fused_detector_kernel<float, 0, 0, false, 0>(float const*)"
    events = [
        {"ph": "X", "cat": "kernel", "name": k1, "dur": 250, "args": {"device": 0, "stream": 7}},
        {"ph": "X", "cat": "kernel", "name": k1, "dur": 100, "args": {"device": 2, "stream": 13}},
        {"ph": "X", "cat": "kernel", "name": k1, "dur": 100, "args": {"device": 2, "stream": 13}},
        {"ph": "X", "cat": "kernel", "name": "ampere_sgemm_128x64_nn", "dur": 8,
         "args": {"device": 1}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy PtoP (Device -> Device)", "dur": 500,
         "args": {"fromDevice": 0, "inDevice": 0, "toDevice": 2, "bytes": 4096}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy PtoP (Device -> Device)", "dur": 2,
         "args": {"fromDevice": 1, "inDevice": 1, "toDevice": 0, "bytes": 1024}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy PtoP (Device -> Device)", "dur": 3,
         "args": {"fromDevice": 0, "inDevice": 0, "toDevice": 2, "bytes": 4096}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)", "dur": 1,
         "args": {"device": 2, "bytes": 8}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)", "dur": 50,
         "args": {"device": 0, "bytes": 64}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "dur": 900, "args": {}},
        {"ph": "i", "name": "Iteration Start: PyTorch Profiler"},
    ]
    launches, copies, busy = mesh_cards.trace_summary(events, mesh_cards.KERNEL)
    assert launches == {0: 1, 2: 2}
    assert copies == {"Memcpy PtoP (Device -> Device) cuda:0 -> cuda:2": [2, 8192],
                      "Memcpy PtoP (Device -> Device) cuda:1 -> cuda:0": [1, 1024],
                      "Memcpy DtoD (Device -> Device)": [1, 8],
                      "Memcpy DtoH (Device -> Pageable)": [1, 64]}
    assert busy == pytest.approx({0: 0.803, 1: 0.01, 2: 0.201})
    assert mesh_cards.trace_summary(events, None)[0] == {0: 1, 1: 1, 2: 2}
    assert mesh_cards.trace_summary([], None) == ({}, {}, {})
