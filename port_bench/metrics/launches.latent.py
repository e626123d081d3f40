"""launches.latent: kernels launched inside the program's ``serve.forward``
span (the model step of ``Predictor._launch``: preprocessing, the encoder
and the classifier), per span, in the traced call."""

from port_bench.core.spans import per_span


def read(ctx):
    return per_span(ctx, "serve.forward", "kernels")
