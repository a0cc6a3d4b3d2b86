"""Frozen copies that make the yardstick: the tile-set generator, the path,
the textures, the compositor's bound arithmetic. Each module names the file
and commit it was copied from. Later changes to the program do not reach
them, so every check measures against the same inputs and arithmetic."""
