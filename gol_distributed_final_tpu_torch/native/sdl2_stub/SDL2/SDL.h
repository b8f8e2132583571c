// Minimal vendored SDL2 API surface — EXACTLY what native/window.cc uses.
//
// Purpose: let window.cc compile and run in-tree with no system libSDL2,
// so the exported golwin_* C ABI and the ctypes declarations in
// viz/window.py (SdlWindow) are exercised together in the tests. The
// no-op implementations live in ../sdl_stub.cc; SDL_PollEvent is backed by
// a small injectable event queue (sdl_stub_push_key / sdl_stub_push_quit)
// so the real golwin_poll_key switch logic is testable.
//
// This is NOT SDL: declarations mirror the real API's shapes (names,
// arities, the struct fields window.cc touches) but constants are local.
// A build against real SDL2 uses the system header (viz/window.py takes
// the include path from pkg-config or sdl2-config).

#ifndef GOL_SDL2_STUB_H
#define GOL_SDL2_STUB_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct SDL_Window SDL_Window;
typedef struct SDL_Renderer SDL_Renderer;
typedef struct SDL_Texture SDL_Texture;
typedef struct SDL_Rect SDL_Rect;

#define SDL_INIT_VIDEO 0x00000020u
#define SDL_WINDOWPOS_CENTERED 0x2FFF0000
#define SDL_WINDOW_SHOWN 0x00000004
#define SDL_RENDERER_ACCELERATED 0x00000002
#define SDL_PIXELFORMAT_ARGB8888 0x16362004
#define SDL_TEXTUREACCESS_STREAMING 1

#define SDL_QUIT 0x100
#define SDL_KEYDOWN 0x300

// SDLK_* are ASCII in real SDL2 too
#define SDLK_p 'p'
#define SDLK_s 's'
#define SDLK_q 'q'
#define SDLK_k 'k'

// Event structs mirror REAL SDL2's field layout (SDL_events.h /
// SDL_keyboard.h), not a minimal shape: sym lands at byte offset 20 of
// the union and the union is padded to SDL2's 56 bytes. window.cc reads
// fields through this header, so compiling against it exercises the same
// offsets a real-SDL build uses — a hardcoded-offset or struct-shape
// mistake in window.cc that would only break on a user's machine breaks
// here instead.
typedef struct {
  int32_t scancode;
  int32_t sym;
  uint16_t mod;
  uint32_t unused;
} SDL_Keysym;

typedef struct {
  uint32_t type;
  uint32_t timestamp;
  uint32_t windowID;
  uint8_t state;
  uint8_t repeat;
  uint8_t padding2;
  uint8_t padding3;
  SDL_Keysym keysym;
} SDL_KeyboardEvent;

typedef union {
  uint32_t type;
  SDL_KeyboardEvent key;
  uint8_t padding[56];
} SDL_Event;

int SDL_Init(uint32_t flags);
void SDL_Quit(void);
SDL_Window* SDL_CreateWindow(const char* title, int x, int y, int w, int h,
                             uint32_t flags);
void SDL_DestroyWindow(SDL_Window* window);
SDL_Renderer* SDL_CreateRenderer(SDL_Window* window, int index,
                                 uint32_t flags);
void SDL_DestroyRenderer(SDL_Renderer* renderer);
SDL_Texture* SDL_CreateTexture(SDL_Renderer* renderer, uint32_t format,
                               int access, int w, int h);
void SDL_DestroyTexture(SDL_Texture* texture);
int SDL_UpdateTexture(SDL_Texture* texture, const SDL_Rect* rect,
                      const void* pixels, int pitch);
int SDL_RenderClear(SDL_Renderer* renderer);
int SDL_RenderCopy(SDL_Renderer* renderer, SDL_Texture* texture,
                   const SDL_Rect* srcrect, const SDL_Rect* dstrect);
void SDL_RenderPresent(SDL_Renderer* renderer);
int SDL_PollEvent(SDL_Event* event);

// -- stub-only test hooks (absent from real SDL2) ---------------------------
void sdl_stub_push_key(int sym);
void sdl_stub_push_quit(void);
// render-call counter so a test can assert golwin_render_frame reached SDL
long sdl_stub_render_count(void);
// BEHAVIORAL hooks: the stub records the SDL call
// sequence and validates arguments/ordering against the real API's
// contract. trace() is the comma-separated call log; violations() is a
// ';'-joined list of contract breaches ("" when clean); reset() clears
// both plus the state machine, for test isolation.
const char* sdl_stub_trace(void);
const char* sdl_stub_violations(void);
void sdl_stub_reset(void);

#ifdef __cplusplus
}
#endif

#endif  // GOL_SDL2_STUB_H
