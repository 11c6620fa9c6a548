"""The plain reference: PyTorch, NumPy and SciPy only, float32, and nothing
of the measured program. It takes the benchmark's waveforms,
weights, BatchNorm statistics and class projections, and works out again
everything the program derives from them: the window, the DFT, the mel
filterbank, the folded weights and every LRP rule."""
