"""One module a kernel, found by file: ``costs/<launch name>.py``, the
name the kernel's wrapper gives `repro_torch.kernels.build.report_launch`.
Each exports ``cost(inputs, outputs) -> (bytes, flops)``: what one launch
on those tensors needs, as 0-d device tensors, computed without a host
sync.  The harness loads every module here when it sets a cell up and
costs each launch its profiled span B records; a launch with no module
is not costed."""
