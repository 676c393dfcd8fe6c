"""The benchmark's plain reference: float32 PyTorch and NumPy, no kernel,
no cache, no batching across clips.

The modules are frozen copies of the port's plain versions (each names its
original), cut loose from the port: nothing here imports the port, JAX or
the JAX package.  `dsp` holds the signal path (resampler, spectral gate,
the 149-dim features, the sequence heads' frames), `quint` the weighted
vote over the sequence heads.  Every function takes the inputs the
benchmark made (audio, weights, configuration) and recomputes what the
port's set-up derives from them.
"""
