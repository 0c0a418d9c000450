"""Counter of ``models.llama._ql`` (a 4-bit projection): operations and
bytes from the activation's rows and the stored weight of the layer the
call reads (codes and scales of one layer of a stack)."""

from bench_port import roofline


def count(rec, call):
    x2, lin = call.args[0], call.args[1]
    rows, in_f = x2.shape
    layers = lin.wp.shape[0] if lin.wp.dim() == 3 else 1
    wbytes = (lin.wp.numel() * lin.wp.element_size()
              + lin.scales.numel() * lin.scales.element_size()) // layers
    ops, nbytes = roofline.linear(rows, lin.out_features, in_f, wbytes,
                                  x2.element_size(),
                                  call.result.element_size())
    rec.add("linear", ops, nbytes)
