"""The benchmark's plain reference: the cloud sky re-stated in eager PyTorch.

A frozen transcription of the NumPy float64 oracle of the upstream shaders
(`transmittance-lut.glsl`, `sky-lut.glsl`, `clouds.glsl`,
`clouds.gdshader`) into plain tensor operations that run on any device in
any float dtype (float64 by default). It imports nothing of the program
under test and takes nothing the program made: it is handed the same
noise textures and scene inputs as the program and works out again the
mip chains, the LUTs, the hemisphere maps and the displayed frame.

- `atmosphere`: the transmittance LUT and the sky-view LUT.
- `clouds`: the texture samplers, the density model and the cloud march
  (the exact 6-step light march: no cone cache, no culling).
- `composite`: the octahedral map's texel directions and the display
  composite.
"""
