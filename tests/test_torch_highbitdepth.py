"""PyTorch port, 10-bit coding (ROADMAP queue 1 item 10b), against the JAX
package at tolerance 0: the port's CPU encode of tests/test_highbitdepth.py's
sequences (64x32, 10 bits, QP 32, search range 8, AI and LDP) equals the
committed JAX stream byte for byte, and the port's DecLib decodes each
with every MD5 OK (the hash over 16-bit samples) to the JAX decoder's
pictures.

No JAX program is compiled here.  Cost on one core: about 1 s."""
import numpy as np
import pytest
import torch

from tests.make_torch_port_streams import assert_tool_run, port_tool_run

torch.set_num_threads(1)


@pytest.mark.parametrize("gop", ["ai", "ldp"])
def test_10bit_stream_matches_jax(gop):
    run = port_tool_run(f"{gop}64x32_10bit_qp32_3f")
    assert max(int(f[0].max()) for f in run["frames"]) > 255
    assert run["dec"].sps.bit_depth == 10
    assert_tool_run(run)
    for f in run["out"]:
        assert int(f.planes[0].max()) <= 1023
        assert np.asarray(f.numpy()[0]).max() > 255
