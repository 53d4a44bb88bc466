"""Data pipeline (port of ``repro.data``): the synthetic dataset
generators (Criteo- and MovieLens-like, numpy, bit-identical to the JAX
package's), the minibatch store and the LM token pipeline. Names are
imported on first use.
"""

from repro_torch._exports import lazy

_SYN = "repro_torch.data.synthetic"
__getattr__ = lazy(__name__, {
    "CriteoLikeConfig": (_SYN, "CriteoLikeConfig"),
    "MovieLensLikeConfig": (_SYN, "MovieLensLikeConfig"),
    "make_criteo_dense": (_SYN, "make_criteo_dense"),
    "make_criteo_sparse": (_SYN, "make_criteo_sparse"),
    "make_movielens": (_SYN, "make_movielens"),
    "MinibatchStore": ("repro_torch.data.store", "MinibatchStore"),
    "TokenPipeline": ("repro_torch.data.tokens", "TokenPipeline"),
    "synthetic_token_batch": ("repro_torch.data.tokens",
                              "synthetic_token_batch"),
})
