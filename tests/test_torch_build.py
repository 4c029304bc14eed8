"""What ``ops/build.py`` reads out of the toolkit's reports, on the CPU.

``chip_smoke.py`` reports each backward kernel's registers, spills and
shared memory from the ``ptxas -v`` log of its build, and its warpgroup MMA
count from ``cuobjdump --dump-sass``; the card test
``test_backward_kernels_issue_wgmma`` counts the same. These tests hold the
two parsers against excerpts in the tools' formats.
"""
from multimodal_edema_prediction_tpu_torch.ops import build

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
