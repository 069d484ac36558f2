"""Pygame renderer for human / rgb_array modes.

Re-implementation of the reference renderer's visual language
(`renderer.py:37-94`): coloured square per tile (HLS hue wheel per colour,
`renderer.py:29-35`), black vertical/horizontal bar for lasers, diamond for
bombs, circle for cookies, black for colourless, moves-left banner on top.
Layout math is intentionally simpler (fixed tile size) — pixel-exactness is
not part of the behavioural contract.
"""

from __future__ import annotations

import colorsys
from typing import Optional

import numpy as np


class Renderer:
    def __init__(
        self,
        num_rows: int,
        num_cols: int,
        num_colours: int,
        num_moves: int,
        render_fps: int = 2,
        render_mode: Optional[str] = "human",
        tile_size: int = 48,
    ) -> None:
        self.num_rows = num_rows
        self.num_cols = num_cols
        self.num_colours = num_colours
        self.num_moves = num_moves
        self.render_fps = render_fps
        self.render_mode = render_mode
        self.tile_size = tile_size
        self.spacing = max(2, tile_size // 24)
        self.margin = 12
        self.text_area = 40
        self.screen = None
        self.colour_map = []
        for i in range(1, num_colours + 1):
            rgb = colorsys.hls_to_rgb(i / num_colours, 0.5, 0.6)
            self.colour_map.append(tuple(int(v * 255) for v in rgb))

    def _init_pygame(self):
        import pygame

        self._pygame = pygame
        pygame.init()
        w = self.num_cols * (self.tile_size + self.spacing) + 2 * self.margin
        h = (
            self.num_rows * (self.tile_size + self.spacing)
            + 2 * self.margin
            + self.text_area
        )
        self.screen_width, self.screen_height = w, h
        if self.render_mode == "human":
            pygame.display.init()
            pygame.display.set_caption("Tile Match")
            self.screen = pygame.display.set_mode((w, h))
            self.clock = pygame.time.Clock()
        else:
            self.screen = pygame.Surface((w, h))
        self.font = pygame.font.SysFont("helvetica", (self.text_area * 8) // 10)

    def render(self, board: np.ndarray, moves_left: int):
        if self.screen is None:
            self._init_pygame()
        pygame = self._pygame
        white, black = (255, 255, 255), (0, 0, 0)
        self.screen.fill(white)
        ts, sp = self.tile_size, self.spacing
        y0 = self.text_area + self.margin
        for r in range(self.num_rows):
            for c in range(self.num_cols):
                colour = int(board[0, r, c])
                kind = int(board[1, r, c])
                color = black if colour == 0 else self.colour_map[colour - 1]
                x = self.margin + c * (ts + sp)
                y = y0 + r * (ts + sp)
                if kind > 0:
                    pygame.draw.rect(self.screen, color, (x, y, ts, ts))
                if kind == 2:  # vertical laser
                    pygame.draw.rect(self.screen, black, (x + ts / 3, y, ts / 3, ts))
                elif kind == 3:  # horizontal laser
                    pygame.draw.rect(self.screen, black, (x, y + ts / 3, ts, ts / 3))
                elif kind == 4:  # bomb
                    pygame.draw.polygon(
                        self.screen,
                        black,
                        [
                            (x + ts / 2, y),
                            (x + ts, y + ts / 2),
                            (x + ts / 2, y + ts),
                            (x, y + ts / 2),
                        ],
                    )
                elif kind == -1:  # cookie
                    pygame.draw.circle(
                        self.screen, black, (x + ts / 2, y + ts / 2), ts / 3
                    )
        text = self.font.render(f"Moves Left: {moves_left}", True, black)
        self.screen.blit(
            text, ((self.screen_width - text.get_width()) / 2, self.margin / 2)
        )
        if self.render_mode == "human":
            pygame.event.pump()
            pygame.display.update()
            self.clock.tick(self.render_fps)
            return None
        return np.transpose(
            np.array(self._pygame.surfarray.pixels3d(self.screen)), axes=(1, 0, 2)
        ).copy()

    def close(self):
        if self.screen is not None:
            self._pygame.display.quit()
            self._pygame.quit()
