"""Flash attention: the model-layout op (``ops.flash_attention``), the
forward kernel (``kernel``), the two-pass backward and its autograd
function (``backward``), and the plain oracle (``ref``)."""
