from .checkpoint import export_ply, import_ply
