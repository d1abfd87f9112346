from .checkpoint import load_checkpoint, save_checkpoint
from .dolfin_xml import read_dolfin_xml, write_dolfin_xml
from .msh import read_msh
from .xdmf import XDMFFile

__all__ = ["save_checkpoint", "load_checkpoint", "XDMFFile", "read_msh",
           "read_dolfin_xml", "write_dolfin_xml"]
