// SDL2 window backend — the one native-UI component of the framework.
//
// Mirrors the reference's SDL window (reference: sdl/window.go:10-104,
// reached there through the go-sdl2 cgo binding): an ARGB8888 streaming
// texture over a byte pixel buffer, with FlipPixel/SetPixel/CountPixels/
// ClearPixels/RenderFrame, plus key polling for the p/s/q/k controls
// (reference: sdl/loop.go:16-28).
//
// Build (requires libSDL2 development headers): viz/window.py builds
// libgolwindow.so with g++ at first use when pkg-config or sdl2-config
// finds libSDL2 (or run `make window` here), and falls back to a headless
// buffer-only window where it cannot.

#include <cstdint>
#include <cstdlib>
#include <cstring>

#ifdef GOL_HAVE_SDL2
#include <SDL2/SDL.h>

struct GolWindow {
  SDL_Window* window;
  SDL_Renderer* renderer;
  SDL_Texture* texture;
  uint32_t* pixels;
  int width;
  int height;
};

extern "C" {

GolWindow* golwin_create(int width, int height, const char* title) {
  if (SDL_Init(SDL_INIT_VIDEO) != 0) return nullptr;
  GolWindow* w = new GolWindow();
  w->width = width;
  w->height = height;
  w->window =
      SDL_CreateWindow(title, SDL_WINDOWPOS_CENTERED, SDL_WINDOWPOS_CENTERED,
                       width, height, SDL_WINDOW_SHOWN);
  w->renderer = SDL_CreateRenderer(w->window, -1, SDL_RENDERER_ACCELERATED);
  w->texture = SDL_CreateTexture(w->renderer, SDL_PIXELFORMAT_ARGB8888,
                                 SDL_TEXTUREACCESS_STREAMING, width, height);
  w->pixels = (uint32_t*)calloc((size_t)width * height, sizeof(uint32_t));
  return w;
}

void golwin_destroy(GolWindow* w) {
  if (!w) return;
  free(w->pixels);
  SDL_DestroyTexture(w->texture);
  SDL_DestroyRenderer(w->renderer);
  SDL_DestroyWindow(w->window);
  SDL_Quit();
  delete w;
}

void golwin_flip_pixel(GolWindow* w, int x, int y) {
  // XOR all channel bytes, like the reference (sdl/window.go FlipPixel)
  w->pixels[(size_t)y * w->width + x] ^= 0x00FFFFFFu;
}

void golwin_set_pixel(GolWindow* w, int x, int y, uint32_t argb) {
  w->pixels[(size_t)y * w->width + x] = argb;
}

long golwin_count_pixels(GolWindow* w) {
  long count = 0;
  for (long i = 0; i < (long)w->width * w->height; i++)
    if (w->pixels[i] & 0x00FFFFFFu) count++;
  return count;
}

void golwin_clear_pixels(GolWindow* w) {
  memset(w->pixels, 0, (size_t)w->width * w->height * sizeof(uint32_t));
}

void golwin_render_frame(GolWindow* w) {
  SDL_UpdateTexture(w->texture, nullptr, w->pixels,
                    w->width * (int)sizeof(uint32_t));
  SDL_RenderClear(w->renderer);
  SDL_RenderCopy(w->renderer, w->texture, nullptr, nullptr);
  SDL_RenderPresent(w->renderer);
}

// Poll one key event; returns the key char ('p','s','q','k'), 0 for none,
// or -1 for window close.
int golwin_poll_key(GolWindow* w) {
  (void)w;
  SDL_Event e;
  while (SDL_PollEvent(&e)) {
    if (e.type == SDL_QUIT) return -1;
    if (e.type == SDL_KEYDOWN) {
      switch (e.key.keysym.sym) {
        case SDLK_p: return 'p';
        case SDLK_s: return 's';
        case SDLK_q: return 'q';
        case SDLK_k: return 'k';
        default: break;
      }
    }
  }
  return 0;
}

}  // extern "C"

#endif  // GOL_HAVE_SDL2
