"""Function-chain composition.

Counterpart of reference utils/combine_functions.py:19-27: pipes a tuple of
arguments through a list of functions, each returning the next call's
arguments.  The framework's canonical chains are explicit fused device ops
(crimac_unet_tpu.ops); this exists for users composing custom host-side
transform chains with the reference idiom.
"""

from __future__ import annotations


class CombineFunctions:
    """combined = CombineFunctions([f, g]); combined(*args) == g(*f(*args))"""

    def __init__(self, functions):
        self.functions = list(functions)

    def __call__(self, *args):
        for f in self.functions:
            args = f(*args)
        return args
