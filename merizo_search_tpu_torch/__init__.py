"""merizo_search_tpu_torch — the PyTorch/CUDA port of the foldsearch engine.

A second package beside the JAX one, for one NVIDIA H100. It runs the
``search`` verb (PDB query -> Foldclass EGNN embedding -> exact top-k over a
device-resident database, with hand-written CUDA kernels for the block-max
scan and the block rescore -> native C++ TM-align rescore -> TSV output),
``createdb`` and ``dbinfo`` (the database builder and inspector) and
``segment`` (the Merizo domain segmenter).

The package imports torch, numpy, scipy and the standard library only. Entry points
take ``device="cuda"`` by default and raise when CUDA is asked for and
absent; ``device="cpu"`` runs every kernel's plain PyTorch version.
"""

__version__ = "0.1.0"
