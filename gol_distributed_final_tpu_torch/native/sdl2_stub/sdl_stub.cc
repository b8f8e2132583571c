// BEHAVIORAL SDL2 stub backing sdl2_stub/SDL2/SDL.h — see the header for
// why this exists. Beyond distinct non-null handles and an injectable
// event queue, the stub now RECORDS the call sequence and VALIDATES each
// call against the real SDL API's contract: init
// ordering, live-handle use, texture pitch, per-frame update/clear/copy/
// present ordering, create/destroy pairing. An SDL-API misuse inside
// window.cc — the kind that would pass a no-op stub and only surface on a
// user's machine with real libSDL2 — lands in sdl_stub_violations(),
// which the window tests assert is empty after driving a real session.
//
// Single-slot by design: one live window/renderer/texture at a time (all
// framework surfaces open at most one window); a concurrent second create
// is itself recorded as a violation.

#include <SDL2/SDL.h>

#include <cstdarg>
#include <cstdio>
#include <cstring>

namespace {
SDL_Event g_queue[64];
int g_head = 0;
int g_tail = 0;
long g_renders = 0;

// ---- behavioral state machine ---------------------------------------------
bool g_inited = false;
int g_win_live = 0, g_ren_live = 0, g_tex_live = 0;  // 0 none, 1 live, -1 dead
int g_win_w = 0, g_win_h = 0;
int g_tex_w = 0, g_tex_h = 0;
bool g_copied_since_present = false;
bool g_cleared_since_present = false;

char g_trace[8192];
size_t g_trace_len = 0;
char g_viol[4096];
size_t g_viol_len = 0;

// handles are addresses of these markers; dead handles stay recognisable
// so use-after-destroy is reported as such, not as "unknown handle"
int g_win_obj, g_ren_obj, g_tex_obj;

void append(char* buf, size_t cap, size_t* len, const char* sep,
            const char* msg) {
  size_t need = strlen(msg) + (*len ? strlen(sep) : 0);
  if (*len + need + 4 >= cap) return;  // full: drop (tests reset first)
  if (*len) {
    memcpy(buf + *len, sep, strlen(sep));
    *len += strlen(sep);
  }
  memcpy(buf + *len, msg, strlen(msg));
  *len += strlen(msg);
  buf[*len] = '\0';
}

void trace(const char* name) { append(g_trace, sizeof g_trace, &g_trace_len, ",", name); }

void violate(const char* fmt, ...) {
  char msg[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(msg, sizeof msg, fmt, ap);
  va_end(ap);
  append(g_viol, sizeof g_viol, &g_viol_len, ";", msg);
}

bool need_init(const char* who) {
  if (!g_inited) {
    violate("%s before SDL_Init", who);
    return false;
  }
  return true;
}

bool check_renderer(const char* who, SDL_Renderer* r) {
  if (r != reinterpret_cast<SDL_Renderer*>(&g_ren_obj) || g_ren_live != 1) {
    violate("%s: %s renderer", who, g_ren_live == -1 ? "destroyed" : "unknown");
    return false;
  }
  return true;
}

bool check_texture(const char* who, SDL_Texture* t) {
  if (t != reinterpret_cast<SDL_Texture*>(&g_tex_obj) || g_tex_live != 1) {
    violate("%s: %s texture", who, g_tex_live == -1 ? "destroyed" : "unknown");
    return false;
  }
  return true;
}

void push(const SDL_Event& e) {
  if ((g_tail + 1) % 64 == g_head) return;  // full: drop (test-only queue)
  g_queue[g_tail] = e;
  g_tail = (g_tail + 1) % 64;
}
}  // namespace

extern "C" {

int SDL_Init(uint32_t flags) {
  trace("Init");
  if (!(flags & SDL_INIT_VIDEO)) violate("SDL_Init without SDL_INIT_VIDEO");
  g_inited = true;
  return 0;
}

void SDL_Quit(void) {
  trace("Quit");
  if (!g_inited) violate("SDL_Quit before SDL_Init");
  if (g_win_live == 1 || g_ren_live == 1 || g_tex_live == 1)
    violate("SDL_Quit with live handles (missing Destroy calls)");
  g_inited = false;
  // real SDL_Quit invalidates everything; a fresh Init may create anew
  g_win_live = g_ren_live = g_tex_live = 0;
}

SDL_Window* SDL_CreateWindow(const char* title, int, int, int w, int h,
                             uint32_t) {
  trace("CreateWindow");
  if (!need_init("SDL_CreateWindow")) return nullptr;
  if (!title) violate("SDL_CreateWindow: null title");
  if (w <= 0 || h <= 0) violate("SDL_CreateWindow: bad size %dx%d", w, h);
  if (g_win_live == 1) violate("SDL_CreateWindow: window already live");
  g_win_live = 1;
  g_win_w = w;
  g_win_h = h;
  return reinterpret_cast<SDL_Window*>(&g_win_obj);
}

void SDL_DestroyWindow(SDL_Window* win) {
  trace("DestroyWindow");
  if (win != reinterpret_cast<SDL_Window*>(&g_win_obj) || g_win_live != 1) {
    violate("SDL_DestroyWindow: %s window",
            g_win_live == -1 ? "double-destroyed" : "unknown");
    return;
  }
  if (g_ren_live == 1)
    violate("SDL_DestroyWindow before SDL_DestroyRenderer");
  g_win_live = -1;
}

SDL_Renderer* SDL_CreateRenderer(SDL_Window* win, int, uint32_t) {
  trace("CreateRenderer");
  if (!need_init("SDL_CreateRenderer")) return nullptr;
  if (win != reinterpret_cast<SDL_Window*>(&g_win_obj) || g_win_live != 1)
    violate("SDL_CreateRenderer: %s window",
            g_win_live == -1 ? "destroyed" : "unknown");
  if (g_ren_live == 1) violate("SDL_CreateRenderer: renderer already live");
  g_ren_live = 1;
  g_copied_since_present = g_cleared_since_present = false;
  return reinterpret_cast<SDL_Renderer*>(&g_ren_obj);
}

void SDL_DestroyRenderer(SDL_Renderer* r) {
  trace("DestroyRenderer");
  if (r != reinterpret_cast<SDL_Renderer*>(&g_ren_obj) || g_ren_live != 1) {
    violate("SDL_DestroyRenderer: %s renderer",
            g_ren_live == -1 ? "double-destroyed" : "unknown");
    return;
  }
  if (g_tex_live == 1)
    violate("SDL_DestroyRenderer before SDL_DestroyTexture");
  g_ren_live = -1;
}

SDL_Texture* SDL_CreateTexture(SDL_Renderer* r, uint32_t format, int access,
                               int w, int h) {
  trace("CreateTexture");
  if (!need_init("SDL_CreateTexture")) return nullptr;
  if (!check_renderer("SDL_CreateTexture", r)) return nullptr;
  if (format != SDL_PIXELFORMAT_ARGB8888)
    violate("SDL_CreateTexture: format 0x%x != ARGB8888", format);
  if (access != SDL_TEXTUREACCESS_STREAMING)
    violate("SDL_CreateTexture: access %d != STREAMING", access);
  if (w <= 0 || h <= 0) violate("SDL_CreateTexture: bad size %dx%d", w, h);
  if (g_tex_live == 1) violate("SDL_CreateTexture: texture already live");
  g_tex_live = 1;
  g_tex_w = w;
  g_tex_h = h;
  return reinterpret_cast<SDL_Texture*>(&g_tex_obj);
}

void SDL_DestroyTexture(SDL_Texture* t) {
  trace("DestroyTexture");
  if (t != reinterpret_cast<SDL_Texture*>(&g_tex_obj) || g_tex_live != 1) {
    violate("SDL_DestroyTexture: %s texture",
            g_tex_live == -1 ? "double-destroyed" : "unknown");
    return;
  }
  g_tex_live = -1;
}

int SDL_UpdateTexture(SDL_Texture* t, const SDL_Rect* rect,
                      const void* pixels, int pitch) {
  trace("Update");
  if (!check_texture("SDL_UpdateTexture", t)) return -1;
  if (!pixels) violate("SDL_UpdateTexture: null pixels");
  // the classic misuse this stub exists to catch: for a full-texture
  // update of a 4-byte format, pitch must be width*4 BYTES (not width,
  // not height*4) — wrong pitch shears every row on a real machine
  if (!rect && pitch != g_tex_w * 4)
    violate("SDL_UpdateTexture: pitch %d != width*4 (%d)", pitch,
            g_tex_w * 4);
  return 0;
}

int SDL_RenderClear(SDL_Renderer* r) {
  trace("Clear");
  if (!check_renderer("SDL_RenderClear", r)) return -1;
  g_cleared_since_present = true;
  return 0;
}

int SDL_RenderCopy(SDL_Renderer* r, SDL_Texture* t, const SDL_Rect*,
                   const SDL_Rect*) {
  trace("Copy");
  if (!check_renderer("SDL_RenderCopy", r)) return -1;
  if (!check_texture("SDL_RenderCopy", t)) return -1;
  g_copied_since_present = true;
  return 0;
}

void SDL_RenderPresent(SDL_Renderer* r) {
  trace("Present");
  if (!check_renderer("SDL_RenderPresent", r)) return;
  if (!g_copied_since_present)
    violate("SDL_RenderPresent without a RenderCopy this frame");
  if (!g_cleared_since_present)
    violate("SDL_RenderPresent without a RenderClear this frame");
  g_copied_since_present = g_cleared_since_present = false;
  g_renders++;
}

int SDL_PollEvent(SDL_Event* event) {
  // not traced: polled every frame, would drown the call log
  if (!g_inited) violate("SDL_PollEvent before SDL_Init");
  if (g_head == g_tail) return 0;
  *event = g_queue[g_head];
  g_head = (g_head + 1) % 64;
  return 1;
}

void sdl_stub_push_key(int sym) {
  SDL_Event e;
  memset(&e, 0, sizeof e);
  // written through the REAL field layout (type at 0, sym at offset 20):
  // golwin_poll_key reading them back round-trips the struct offsets
  e.key.type = SDL_KEYDOWN;
  e.key.state = 1;  // SDL_PRESSED
  e.key.keysym.sym = sym;
  push(e);
}

void sdl_stub_push_quit(void) {
  SDL_Event e;
  memset(&e, 0, sizeof e);
  e.type = SDL_QUIT;
  push(e);
}

long sdl_stub_render_count(void) { return g_renders; }

const char* sdl_stub_trace(void) { return g_trace; }

const char* sdl_stub_violations(void) { return g_viol; }

void sdl_stub_reset(void) {
  g_head = g_tail = 0;
  g_renders = 0;
  g_inited = false;
  g_win_live = g_ren_live = g_tex_live = 0;
  g_win_w = g_win_h = g_tex_w = g_tex_h = 0;
  g_copied_since_present = g_cleared_since_present = false;
  g_trace[0] = g_viol[0] = '\0';
  g_trace_len = g_viol_len = 0;
}

}  // extern "C"
