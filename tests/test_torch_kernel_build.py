"""How the port's CUDA sources are built, checked without a compiler:
``ops/_cuda.py::library_path`` names a library by a hash of its source,
of every header in ``csrc/`` and of the flags, so an edited header
rebuilds every library that includes it; the three attention kernels
take their shared device code from one header and define none of it
themselves, and the two kernels fed by TMA (the int4 GEMM and paged
decode) take their mbarrier, TMA and tensor-map helpers from another.
"""

import re
import shutil

from ai_agent_kubectl_tpu_torch.ops import _cuda

ATTENTION = ("ragged_attention", "flash_attention", "paged_attention")
SHARED = ("cp_async16", "ldmatrix_x4", "ldmatrix_x4_trans", "mma_bf16",
          "pack_bf16x2", "quad_max", "quad_sum", "mma_attend_step",
          "combine_row", "key_split")
TMA_USERS = ("int4_matmul", "paged_attention")
TMA_SHARED = ("smem_u32", "mbar_init", "mbar_expect_tx", "mbar_arrive",
              "mbar_wait", "tma_load_2d", "tma_load_3d", "tma_load_4d",
              "fence_proxy_async", "encoder", "encode")


def test_library_path_hashes_every_header(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, csrc)
    before = {n: _cuda.library_path(n, csrc) for n in _cuda.SOURCES}
    assert before == {n: _cuda.library_path(n) for n in _cuda.SOURCES}
    header = csrc / "attention_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _cuda.library_path(n, csrc) for n in _cuda.SOURCES}
    assert all(after[n] != before[n] for n in _cuda.SOURCES)
    (csrc / "new_header.cuh").write_text("#pragma once\n")
    again = {n: _cuda.library_path(n, csrc) for n in _cuda.SOURCES}
    assert all(again[n] != after[n] for n in _cuda.SOURCES)
    # A source's own edit moves its library alone.
    src = csrc / "flash_attention.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    last = {n: _cuda.library_path(n, csrc) for n in _cuda.SOURCES}
    assert [n for n in _cuda.SOURCES if last[n] != again[n]] == [
        "flash_attention"]


def test_attention_sources_share_one_header():
    header = (_cuda.CSRC / "attention_mma.cuh").read_text()
    for fn in SHARED:
        assert re.search(rf"\b{fn}\(", header), fn
    for name in ATTENTION:
        src = (_cuda.CSRC / f"{name}.cu").read_text()
        assert '#include "attention_mma.cuh"' in src, name
        for fn in SHARED:
            # Called, never defined again: no return type before the name.
            assert not re.search(rf"(void|float|uint32_t|int)\s+{fn}\(",
                                 src), f"{name} defines {fn}"
        # Each kernel's split plan lives in its source alone.
        plan = {"ragged_attention": "ragged_attention_plan",
                "flash_attention": "flash_attention_plan",
                "paged_attention": "paged_decode_plan"}[name]
        assert f'extern "C" int {plan}(' in src


def test_tma_kernels_share_one_header():
    header = (_cuda.CSRC / "hopper_tma.cuh").read_text()
    for fn in TMA_SHARED:
        assert re.search(rf"\b{fn}\(", header), fn
    for name in TMA_USERS:
        src = (_cuda.CSRC / f"{name}.cu").read_text()
        assert '#include "hopper_tma.cuh"' in src, name
        for fn in TMA_SHARED:
            # Used, never defined again: no return type before the name.
            assert not re.search(
                rf"(void|bool|uint32_t|EncodeTiled)\s+{fn}\(", src), (
                    f"{name} defines {fn}")
