"""The idle share's interval arithmetic and the kernel-name classes."""

import pytest

from gpubench import trace


def test_merge_busy_unions_overlaps():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (10.0, 10.0), (5.0, 4.0)]
    assert trace.merge_busy(spans) == pytest.approx(3.0)
    assert trace.merge_busy([]) == 0.0


def test_idle_gaps_inside_the_window():
    spans = [(1.0, 2.0), (1.5, 3.0), (5.0, 6.0)]
    assert trace.idle_gaps(spans, 0.0, 7.0) == [(0.0, 1.0), (3.0, 5.0), (6.0, 7.0)]
    s = trace.TraceSummary(window_s=7.0, busy_s=3.0, host_ops=[("aten::item", 3.5, 4.8)],
                           device_span=(1.0, 6.0))
    assert s.gaps(spans) == [["aten::item", 2.0]]


NAMES = {
    "void conv3_kernel<64, 2, true>(Conv3Args)": "port_conv",
    "conv3_f32_kernel": "port_conv",
    "conv3_dw_partial_kernel": "port_conv",
    "conv3_dw_f32_reduce_kernel": "port_conv",
    "conv3_stats_reduce_kernel": "port_conv",
    "pool2x_kernel": "port_pool",
    "pool2x_bwd_kernel": "port_pool",
    "upconv_d2s_kernel": "port_upconv",
    "head1x1_dw_reduce_kernel": "port_head",
    "Memcpy HtoD (Pinned -> Device)": "copy",
    "Memset (Device)": "copy",
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)": "collective",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_ndhwc_kernel": "library_conv",
    "void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>": "library_conv",
    "sm80_xmma_wgrad_implicit_gemm_indexed_bf16bf16": "library_conv",
    "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32": "matmul",
    "void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_64x64_16x6_tn_align4>": "matmul",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>":
        "elementwise",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, MeanOps>>": "elementwise",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, unsigned int, 3>":
        "elementwise",
    "void at::native::unrolled_elementwise_kernel<direct_copy_kernel_cuda, convert>": "elementwise",
}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_kernel_classes(name):
    assert trace.classify(name, trace.load_classes()) == NAMES[name]
