"""Byte counts behind each kernel's roofline share, one module a kernel.

Each module names the kernels it covers (``KERNELS``, matched inside the
trace's kernel names) and gives ``bytes_moved(work, channels, side)``:
what the function must read once and write once for one frame, worked
out from its own inputs and outputs, so that the count stays the same
whichever implementation runs.  ``peaks.json`` holds the published
bandwidth of each card by the name ``torch.cuda.get_device_name`` gives.
"""
