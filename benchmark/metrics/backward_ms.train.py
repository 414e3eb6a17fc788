"""``backward_ms.train``: device ms per training step of the loss and the
backward pass (the render's IFT backward, K7's routing, the sigmoid's) and
the SGD update, the kernels launched inside the span ``backward``."""
from benchmark.trace import span_ms


def read(rc):
    return span_ms(rc, "backward")
