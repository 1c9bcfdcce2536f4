"""Host-side data path: blob meshes, P1 FEM assembly, graph samples."""
