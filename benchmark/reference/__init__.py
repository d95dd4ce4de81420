"""The plain reference: float32 PyTorch with TF32 off, written from the
published U-Net and the reference pipeline's laws.  It imports nothing of
the program and takes nothing the program made.
"""
