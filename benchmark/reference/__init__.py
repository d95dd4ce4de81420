"""The plain reference: float32 PyTorch with TF32 off, written from the
published models (one file an architecture, reached through its adapter
under ``benchmark/architectures/``) and the reference pipeline's laws.  It
imports nothing of the program and takes nothing the program made.
"""
