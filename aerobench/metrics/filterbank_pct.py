"""Filterbank: the share of the profiled stretch's busy device time that
the WOLA filterbank's fold and FFT take, in percent.  The fold is the one
grouped cuDNN convolution of ``channelizer/pfb.py:pfb_channelize_fused``
(groups = K; no other step of the program groups a convolution), the FFT
cuFFT's batched 128-point kernel (K = 128 on the 4x plan at 1.536 MS/s;
the demodulators' FFTs are 8192 points and up).  Both are selected by
their exact names in ``cband44feeder.busy``'s trace on an H100 (PyTorch
2.11, CUDA 12.8); the twiddle product and the row copies are elementwise
kernels that other steps share, and are left out."""

NAMES = (
    "void cudnn::cnn::conv2d_grouped_direct_kernel<false, true, false, "
    "false, false, false, 1, 0, int, float, float, float, float, float, "
    "float>(cudnn::cnn::GroupedDirectFpropParams, float const*, float "
    "const*, float*, float, float, float const*, float const*, float "
    "const*, float const*, cudnnActivationStruct)",
    "void vector_fft<128u, EPT<8u>, 2u, 32u, (padding_t)70, (twiddle_t)0, "
    "(loadstore_modifier_t)2, (layout_t)0, unsigned int, float, "
    "HostConfigPlaceholder>(kernel_arguments_t<unsigned int>)",
)


def read(trace, run):
    secs = sum(v for k, v in trace.kernel_s.items() if k in NAMES)
    if not secs or not trace.busy_s:
        return None
    return 100.0 * secs / trace.busy_s
