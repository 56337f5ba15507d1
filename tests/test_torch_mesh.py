"""``launch/mesh.py``: the port's ``parse_mesh`` against the reference's on
the same ``--mesh`` / ``--mesh-axes`` specs and errors (exact), and the
meshes' refusals: a mesh needs a process group of exactly its ranks, and
one on the card no more GPUs than there are. A one-rank gloo group runs in
this process (``launch.mesh.ranks``); larger worlds are
``test_torch_distributed.py``'s.
"""

import pytest
import torch
import torch.distributed as dist

from repro.launch.mesh import parse_mesh as j_parse_mesh
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.serve import mesh_size

CPU = torch.device("cpu")

SPECS = [("1", "data,model"), ("2", "data,model"), ("16", "data,model"),
         ("1x1", "data,model"), ("1x2", "data,model"), ("4x2", "data,model"),
         ("2x4x2", "pod,data,model"), ("8", "pod,data,model"),
         ("3", "model"), ("2x2", " data , model "), ("4", "data")]
BAD = [("1x2x2", "data,model"), ("2", ""), ("0x2", "data,model"),
       ("two", "data,model"), ("2x", "data,model"), ("-1", "model"),
       ("1x2", ",,")]


@pytest.mark.parametrize("spec,axes", SPECS)
def test_parse_mesh_equals_the_reference(spec, axes):
    assert mesh_lib.parse_mesh(spec, axes) == j_parse_mesh(spec, axes)
    sizes = j_parse_mesh(spec, axes)[0]
    assert mesh_size(spec, axes) == mesh_lib.mesh_ranks(sizes)


@pytest.mark.parametrize("spec,axes", BAD)
def test_parse_mesh_errors_equal_the_reference(spec, axes):
    with pytest.raises(ValueError) as want:
        j_parse_mesh(spec, axes)
    with pytest.raises(ValueError) as got:
        mesh_lib.parse_mesh(spec, axes)
    assert str(got.value) == str(want.value)


def test_one_rank_mesh_and_its_refusals():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs a process group of 2"):
        mesh_lib.make_cli_mesh("1x2", device=CPU)
    with pytest.raises(RuntimeError, match="started"):
        with mesh_lib.ranks(2, CPU):
            pass
    with mesh_lib.ranks(1, CPU):
        mesh = mesh_lib.make_cli_mesh("1x1", device=CPU)
        assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
        assert mesh.coordinate("model") == 0 and mesh.device == CPU
        host = mesh_lib.make_host_mesh(device=CPU)
        assert host.axis_names == ("data", "model")
        with pytest.raises(RuntimeError, match="--mesh 2x1 needs 2 ranks, "
                                               "have 1"):
            mesh_lib.make_cli_mesh("2x1", device=CPU)
        with pytest.raises(RuntimeError, match="needs 256 ranks, have 1"):
            mesh_lib.make_production_mesh(device=CPU)
        with pytest.raises(RuntimeError, match="needs 512 ranks"):
            mesh_lib.make_production_mesh(multi_pod=True, device=CPU)
    assert not dist.is_initialized()


def test_a_mesh_on_the_card_counts_its_gpus(monkeypatch):
    """More ranks than GPUs raises, naming both counts, before any rank
    starts."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 GPUs .* have 1"):
        mesh_lib.spawn(print, 2, torch.device("cuda"))
    mesh_lib.check_devices(1, torch.device("cuda"), "one rank")
