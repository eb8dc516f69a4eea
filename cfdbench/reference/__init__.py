"""The plain reference of the hybrid PISO step that decides `correct`.

A frozen copy of the port's plain PyTorch code (the case build, the FV
operators, the momentum and pressure steps, the multigrid polish and the
surrogate's features, blocks, PCA, MLP and stitch), with every kernel
replaced by its plain form (`stencil`). It imports nothing of the
measured program: it builds its cases, masks, apertures, hierarchy and
stitch operators again from the same geometry and the same bundle file.
"""
