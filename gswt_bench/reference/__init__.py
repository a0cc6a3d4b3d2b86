"""The plain reference that decides `correct`.

Plain NumPy and PyTorch: it imports nothing of the program under test (a
test holds it to that). From the benchmark's own inputs (the raw tile set,
the textures, the configuration's user data and the camera pose of each
judged frame) it works out the splat store, the height map, the camera,
the projection, the composite, the skybox and the proxy ground again. It
renders from the program's draw list (which tile instances, LODs, presort
views, merged streams and order each frame drew) once `drawlist.check` has
held that list to the tile engine's semantics, and checks the list's inputs
on their own (`store.presort_inversions`): the store, the height map and
the presorted lists.
"""
