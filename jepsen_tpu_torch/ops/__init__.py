"""Device search engines and the CUDA kernels they launch."""
