"""What ``ops/build.py`` reads out of the toolkit's reports, and the C
entry points ``ops/attention.py``, ``ops/gather.py``, ``ops/dual_axis.py``
and ``ops/ln_qkv.py`` bind, on the CPU.

``chip_smoke.py`` reports K1's bf16 kernels' registers, spills, shared
memory and ptxas warnings from the ``ptxas -v`` log of their build, and
their warpgroup MMA count from ``cuobjdump --dump-sass`` (the float32
kernels' mma.sync of the TF32 form); the card tests
``test_backward_kernels_issue_wgmma``, ``test_forward_kernel_issues_wgmma``
and ``test_float32_kernels_issue_tf32_mma`` count the same. These tests
hold the parsers against excerpts in the tools' formats, and the ctypes
signatures against the ``extern "C"`` declarations of ``csrc/``, which no
compiler checks here.
"""
import ctypes
import os
import re

import pytest

from multimodal_edema_prediction_tpu_torch.data import native_loader
from multimodal_edema_prediction_tpu_torch.ops import (attention, build,
                                                       dual_axis, gather,
                                                       jpeg, ln_qkv)

PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118flash_bwd_dkv_bf16E4Maps6Params' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118flash_bwd_dkv_bf16E4Maps6Params
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1024 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117flash_bwd_dkv_f32E6Params' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117flash_bwd_dkv_f32E6Params
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 37376 bytes smem, 576 bytes cmem[0]
"""

SASS = """\
	code for sm_90a
		Function : _ZN12_GLOBAL__N_117flash_bwd_dq_bf16E4Maps6Params
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0410*/                   WARPGROUP.ARRIVE ;                        /* 0x0000000000007983 */
        /*0420*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;  /* 0x00200000081879f0 */
        /*0430*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR12], R24 ;  /* 0x00200000001879f0 */
        /*0440*/              @!P0 HGMMA.64x64x16.F32.BF16 R56, R88, gdesc[UR4], R56, gsb0 ;  /* 0x00200000001879f0 */
        /*0450*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;           /* 0x00000000000079af */
		Function : _ZN12_GLOBAL__N_117flash_bwd_dq_f32E6Params
        /*0010*/                   FFMA R3, R4, R5, R3 ;                     /* 0x0000000504037223 */
		Function : _ZN12_GLOBAL__N_118flash_bwd_dkv_bf16E4Maps6Params
        /*0080*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;  /* 0x00200000081879f0 */
"""


def test_ptxas_usage_per_entry_function():
    got = build.ptxas_usage(PTXAS)
    assert got == {
        "_ZN12_GLOBAL__N_118flash_bwd_dkv_bf16E4Maps6Params": {
            "registers": 168, "spill_stores": 0, "spill_loads": 0,
            "smem_bytes": 0},
        "_ZN12_GLOBAL__N_117flash_bwd_dkv_f32E6Params": {
            "registers": 255, "spill_stores": 12, "spill_loads": 16,
            "smem_bytes": 37376}}


def test_ptxas_usage_of_an_empty_log():
    assert build.ptxas_usage("") == {}


def test_sass_opcode_counts_per_function():
    got = build.sass_opcode_counts(SASS, "HGMMA")
    assert got == {"_ZN12_GLOBAL__N_117flash_bwd_dq_bf16E4Maps6Params": 3,
                   "_ZN12_GLOBAL__N_117flash_bwd_dq_f32E6Params": 0,
                   "_ZN12_GLOBAL__N_118flash_bwd_dkv_bf16E4Maps6Params": 1}
    # an opcode is matched whole: the warpgroup fences are not HGMMAs
    assert sum(build.sass_opcode_counts(SASS, "WARPGROUP").values()) == 2
    assert sum(build.sass_opcode_counts(SASS, "HMMA").values()) == 0


TF32_SASS = """\
	code for sm_90a
		Function : _ZN12_GLOBAL__N_113flash_fwd_f32ENS_6ParamsE
        /*0400*/                   HMMA.1688.F32.TF32 R24, R88, R92, RZ ;  /* 0x0000005c5818723c */
        /*0410*/                   HMMA.1688.F32.TF32 R24, R80, R84, R24 ;  /* 0x000000545018723c */
        /*0420*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;  /* 0x0000000c0804723c */
		Function : _ZN12_GLOBAL__N_117ln_qkv_f32_kernelENS_14LnQkvF32ParamsE
        /*0100*/              @!P0 HMMA.1688.F32.TF32 R4, R8, R12, R4 ;  /* 0x0000000c0804823c */
        /*0110*/                   FFMA R3, R4, R5, R3 ;                     /* 0x0000000504037223 */
		Function : _ZN12_GLOBAL__N_112ln_stats_f32EPKfP6float2xif
        /*0010*/                   FADD R3, R4, R5 ;                         /* 0x0000000504037221 */
"""


@pytest.mark.parametrize("form,want", [
    ("TF32", (2, 1, 0)), (None, (3, 1, 0)), ("BF16", (1, 0, 0))])
def test_sass_opcode_counts_of_a_form(form, want):
    """The float32 kernels' products are HMMA of the TF32 form
    (``HMMA.1688.F32.TF32``, mma.sync m16n8k8); ``form`` picks the
    instructions among whose suffixes it is, and a bf16 HMMA is not one."""
    got = build.sass_opcode_counts(TF32_SASS, "HMMA", form)
    assert tuple(got.values()) == want, got
    assert list(got) == [
        "_ZN12_GLOBAL__N_113flash_fwd_f32ENS_6ParamsE",
        "_ZN12_GLOBAL__N_117ln_qkv_f32_kernelENS_14LnQkvF32ParamsE",
        "_ZN12_GLOBAL__N_112ln_stats_f32EPKfP6float2xif"]


F32_PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117ln_qkv_f32_kernelENS_14LnQkvF32ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117ln_qkv_f32_kernelENS_14LnQkvF32ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 448 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113flash_fwd_f32ENS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113flash_fwd_f32ENS_6ParamsE
    0 bytes stack frame, 48 bytes spill stores, 48 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 480 bytes cmem[0]
"""


def test_ptxas_usage_of_the_float32_kernels():
    """Registers and spills of the float32 kernels, which keep their
    shared memory dynamic (0 static bytes)."""
    got = build.ptxas_usage(F32_PTXAS)
    assert got == {
        "_ZN12_GLOBAL__N_117ln_qkv_f32_kernelENS_14LnQkvF32ParamsE": {
            "registers": 255, "spill_stores": 0, "spill_loads": 0,
            "smem_bytes": 0},
        "_ZN12_GLOBAL__N_113flash_fwd_f32ENS_6ParamsE": {
            "registers": 255, "spill_stores": 48, "spill_loads": 48,
            "smem_bytes": 0}}


BWD_F32_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117flash_bwd_dq_f32ENS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117flash_bwd_dq_f32ENS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 222 registers, used 1 barriers, 576 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117flash_bwd_dkv_f32ENS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117flash_bwd_dkv_f32ENS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 234 registers, used 1 barriers, 576 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118flash_bwd_dkv_bf16ENS_4MapsENS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118flash_bwd_dkv_bf16ENS_4MapsENS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1024 bytes cmem[0]
"""

BWD_F32_SASS = """\
	code for sm_90a
		Function : _ZN12_GLOBAL__N_117flash_bwd_dq_f32ENS_6ParamsE
        /*0400*/                   HMMA.1688.F32.TF32 R24, R88, R92, RZ ;  /* 0x0000005c5818723c */
        /*0410*/                   HMMA.1688.F32.TF32 R24, R80, R84, R24 ;  /* 0x000000545018723c */
		Function : _ZN12_GLOBAL__N_117flash_bwd_dkv_f32ENS_6ParamsE
        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R12, RZ ;  /* 0x0000000c0804723c */
        /*0110*/                   HMMA.1688.F32.TF32 R4, R8, R14, R4 ;  /* 0x0000000e0804723c */
        /*0120*/                   HMMA.1688.F32.TF32 R4, R10, R12, R4 ;  /* 0x0000000c0a04723c */
		Function : _ZN12_GLOBAL__N_118flash_bwd_dkv_bf16ENS_4MapsENS_6ParamsE
        /*0080*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;  /* 0x00200000081879f0 */
"""


@pytest.mark.parametrize("kernel,registers,hmma", [
    ("flash_bwd_dkv_f32", 234, 3), ("flash_bwd_dq_f32", 222, 2)])
def test_float32_backward_kernel_facts(kernel, registers, hmma):
    """What ``chip_smoke.py``'s ``build_facts`` reports of the float32 dkv
    and dq, each found by its name as there: registers and spills from the
    ``ptxas -v`` log, its mma.sync of the TF32 form from the SASS (the bf16
    kernel beside it neither matched nor counted)."""
    usage = [u for fn, u in build.ptxas_usage(BWD_F32_LOG).items()
             if kernel in fn]
    assert usage == [{"registers": registers, "spill_stores": 0,
                      "spill_loads": 0, "smem_bytes": 0}]
    counts = build.sass_opcode_counts(BWD_F32_SASS, "HMMA", "TF32")
    assert [n for fn, n in counts.items() if kernel in fn] == [hmma]


WARNINGS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114flash_fwd_bf16E4Maps6Params' for 'sm_90a'
ptxas warning : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized due to the presence of Extern calls in the function '_ZN12_GLOBAL__N_114flash_fwd_bf16E4Maps6Params'.
ptxas warning : (C7508) Potential Performance Loss: wgmma.mma_async instructions are serialized.
ptxas info    : (C7514) Potential Performance Loss: wgmma.mma_async instructions are serialized due to non wgmma instructions reading accumulator registers of  a wgmma between start and end of the pipeline stage in the function '_ZN12_GLOBAL__N_114flash_fwd_bf16E4Maps6Params'
ptxas info    : Used 168 registers, used 1 barriers, 1024 bytes cmem[0]
"""


def test_ptxas_coded_messages_with_their_functions():
    got = build.ptxas_warnings(WARNINGS)
    assert [(w["code"], w["function"]) for w in got] == [
        ("C7515", "_ZN12_GLOBAL__N_114flash_fwd_bf16E4Maps6Params"),
        ("C7508", None),
        ("C7514", "_ZN12_GLOBAL__N_114flash_fwd_bf16E4Maps6Params")]
    assert got[0]["text"].startswith("Potential Performance Loss")
    assert build.ptxas_warnings(PTXAS) == []


SETMAXREG_SASS = """\
		Function : _ZN12_GLOBAL__N_118ln_qkv_bf16_kernelE14CUtensorMap_stS0_NS_11LnQkvParamsE
        /*0200*/                   USETMAXREG.DEALLOC.CTAPOOL 0x28 ;        /* 0x00000028000079c8 */
        /*0a10*/                   USETMAXREG.TRY_ALLOC.CTAPOOL P0, 0xe8 ;  /* 0x000000e8000079c8 */
        /*0a20*/              @!P0 BRA 0xa10 ;                              /* 0xfffffff800f88947 */
        /*0a30*/                   USETMAXREG.TRY_ALLOC.CTAPOOL P0, 0xe8 ;  /* 0x000000e8000079c8 */
		Function : _ZN12_GLOBAL__N_117ln_qkv_f32_kernelEPKfS1_S1_S1_S1_Pfiiiif
        /*0010*/                   FFMA R3, R4, R5, R3 ;                     /* 0x0000000504037223 */
"""


def test_sass_setmaxnreg_per_function():
    """The register counts a warp-specialised kernel asks for after launch
    (producer 40, consumers 232), read from its SASS; a function that asks
    for none has no entry."""
    assert build.sass_setmaxnreg(SETMAXREG_SASS) == {
        "_ZN12_GLOBAL__N_118ln_qkv_bf16_kernelE14CUtensorMap_stS0_NS_"
        "11LnQkvParamsE": {"DEALLOC": [40], "TRY_ALLOC": [232]}}
    assert build.sass_setmaxnreg(SASS) == {}


_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong, "unsigned int": ctypes.c_uint}


def _c_signature(source: str, name: str) -> list:
    """The parameters of the ``extern "C"`` function ``name`` of
    ``csrc/<source>`` as ctypes types (every pointer a void pointer, as
    ctypes passes it)."""
    with open(os.path.join(build.CSRC, source)) as f:
        found = re.findall(r'extern "C" int ' + name + r"\(([^)]*)\)",
                           f.read())
    assert len(found) == 1, (source, name)
    return [ctypes.c_void_p if "*" in p
            else _C_TYPES[" ".join(p.split()[:-1])]
            for p in found[0].split(",")]


ENTRY_POINTS = {**attention.ENTRY_POINTS, **gather.ENTRY_POINTS,
                **ln_qkv.ENTRY_POINTS, **dual_axis.ENTRY_POINTS,
                **jpeg.ENTRY_POINTS}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_signatures_match_the_c_sources(name):
    """Every C entry point the port binds (K1's forward with its tensor
    maps, D, dkv and dq; K2's bulk and vector copies; K3's SIMT and
    tensor-core kernels; K4): the library each
    is bound from builds from a source that declares it, with the
    parameters ctypes is told."""
    lib, argtypes = ENTRY_POINTS[name]
    assert _c_signature(build.SOURCES[lib], name) == argtypes


def test_entry_point_tables_do_not_overlap():
    """No C entry point is bound by two wrappers."""
    tables = (attention.ENTRY_POINTS, gather.ENTRY_POINTS,
              ln_qkv.ENTRY_POINTS, dual_axis.ENTRY_POINTS,
              jpeg.ENTRY_POINTS)
    assert sum(map(len, tables)) == len(ENTRY_POINTS)


_HOST_TYPES = {"int32_t": ctypes.c_int, "int64_t": ctypes.c_longlong}


@pytest.mark.parametrize("name", sorted(native_loader.ENTRY_POINTS))
def test_host_decoder_signatures_match_the_source(name):
    """The host JPEG decoder's C entry points (``csrc/host/
    jpeg_decode.cpp``, built with g++) take the parameters ctypes is
    told."""
    with open(native_loader.SOURCE) as f:
        found = re.findall(r"\nvoid " + name + r"\(([^)]*)\)", f.read())
    assert len(found) == 1, name
    want = [ctypes.c_void_p if "*" in p
            else _HOST_TYPES[" ".join(p.split()[:-1])]
            for p in found[0].split(",")]
    assert native_loader.ENTRY_POINTS[name] == want


def test_nvjpeg_resize_links_nvjpeg():
    """The card's decoder links nvJPEG, and the link flag is part of the
    library's hash."""
    assert build.SOURCES["jpeg_resize"] == "jpeg_resize.cu"
    assert build.LINK_FLAGS == {"jpeg_resize": ("-lnvjpeg",)}
    assert build._lib_path("jpeg_resize") != build._lib_path("gather_rows")

