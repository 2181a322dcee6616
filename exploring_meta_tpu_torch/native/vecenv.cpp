// Native vectorized environment stepping service.
//
// TPU-native replacement for the reference's env parallelism
// (l2l AsyncVectorEnv subprocess pool, utils/env_maker.py:18-21,42-45):
// instead of one OS process + pipe round-trip per env per step, a thread
// pool steps all E env instances inside one shared address space, and the
// Python boundary is crossed ONCE per step for the whole batch (pointer
// handoff of [E, obs]/[E, act] buffers, zero copies).
//
// The service is env-agnostic through a small C vtable; a C++ Particles2D
// implementation is built in (bit-compatible with the pure-JAX device env
// in envs/particles2d.py) both as the host fallback and as a validation
// fixture for the protocol; Python-object physics (MuJoCo, Meta-World)
// registers through vecenv_create_python's indexed callbacks.
//
// C ABI only — bound from Python with ctypes (no pybind11 in this image).

#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Env vtable: any environment exposes these three functions over an opaque
// per-instance state blob.
// ---------------------------------------------------------------------------

typedef void (*env_reset_fn)(void* state, const double* task, double* obs);
// step: reads action, writes obs/reward/done/success; returns nothing.
typedef void (*env_step_fn)(void* state, const double* action, double* obs,
                            double* reward, double* done, double* success);

struct EnvVTable {
  env_reset_fn reset;
  env_step_fn step;
  int obs_size;
  int action_size;
  int state_bytes;
};

// ---------------------------------------------------------------------------
// Built-in Particles2D (envs/particles2d.py parity: action clip 0.1,
// reward = -dist(pos, goal), done when BOTH |dx| and |dy| < 0.01 — the
// l2l per-coordinate box termination, deviations registry D5 — frozen
// after done).
// ---------------------------------------------------------------------------

struct P2DState {
  double pos[2];
  double goal[2];
  double done;
};

static void p2d_reset(void* s, const double* task, double* obs) {
  auto* st = reinterpret_cast<P2DState*>(s);
  st->pos[0] = 0.0;
  st->pos[1] = 0.0;
  st->goal[0] = task[0];
  st->goal[1] = task[1];
  st->done = 0.0;
  obs[0] = 0.0;
  obs[1] = 0.0;
}

static void p2d_step(void* s, const double* action, double* obs,
                     double* reward, double* done, double* success) {
  auto* st = reinterpret_cast<P2DState*>(s);
  const double kMaxAct = 0.1, kThresh = 0.01;
  if (st->done < 0.5) {
    for (int i = 0; i < 2; ++i) {
      double a = action[i];
      if (a > kMaxAct) a = kMaxAct;
      if (a < -kMaxAct) a = -kMaxAct;
      st->pos[i] += a;
    }
  }
  double dx = st->pos[0] - st->goal[0];
  double dy = st->pos[1] - st->goal[1];
  double dist = std::sqrt(dx * dx + dy * dy);
  *reward = -dist;
  // l2l Particles2DEnv box termination (matches envs/particles2d.py and
  // the Pallas kernel after the round-3 D5 fix)
  bool done_now = std::abs(dx) < kThresh && std::abs(dy) < kThresh;
  if (done_now) st->done = 1.0;
  *done = st->done;
  *success = done_now ? 1.0 : 0.0;
  obs[0] = st->pos[0];
  obs[1] = st->pos[1];
}

// ---------------------------------------------------------------------------
// Thread-pool batched stepper.
// ---------------------------------------------------------------------------

struct VecEnv {
  EnvVTable vt;
  int n_envs;
  int n_threads;
  std::vector<std::vector<uint8_t>> states;

  // worker pool
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::function<void(int)> job;  // per-env job
  std::atomic<int> next_env{0};
  std::atomic<int> remaining{0};
  uint64_t generation = 0;
  bool shutdown = false;

  explicit VecEnv(EnvVTable v, int envs, int threads)
      : vt(v), n_envs(envs), n_threads(threads) {
    states.resize(envs);
    for (auto& s : states) s.assign(vt.state_bytes, 0);
    for (int t = 0; t < n_threads; ++t) {
      workers.emplace_back([this] { worker_loop(); });
    }
  }

  ~VecEnv() {
    {
      std::lock_guard<std::mutex> lk(mu);
      shutdown = true;
      ++generation;
    }
    cv_work.notify_all();
    for (auto& w : workers) w.join();
  }

  void worker_loop() {
    uint64_t seen = 0;
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return shutdown || generation != seen; });
        if (shutdown) return;
        seen = generation;
      }
      for (;;) {
        int i = next_env.fetch_add(1);
        if (i >= n_envs) break;
        job(i);
        if (remaining.fetch_sub(1) == 1) {
          // Acquire mu before notifying: without it the decrement can
          // land between the waiter's predicate check and its block,
          // and the notify is lost (classic lost-wakeup) — run_batch
          // would sleep forever.
          std::lock_guard<std::mutex> done_lk(mu);
          cv_done.notify_one();
        }
      }
    }
  }

  void run_batch(std::function<void(int)> fn) {
    if (n_threads == 0) {  // synchronous fallback
      for (int i = 0; i < n_envs; ++i) fn(i);
      return;
    }
    std::unique_lock<std::mutex> lk(mu);
    job = std::move(fn);
    remaining.store(n_envs);
    ++generation;
    // Publish the claim counter LAST: a straggler worker from the
    // previous batch that claims an index sees `job` and `remaining`
    // already set (seq_cst store/fetch_add ordering). Resetting it
    // first would let that straggler decrement `remaining` before the
    // store, losing a completion count and hanging the wait below.
    next_env.store(0);
    cv_work.notify_all();
    cv_done.wait(lk, [&] { return remaining.load() == 0; });
  }
};

// ---------------------------------------------------------------------------
// Python-backed envs: physics that lives in Python objects (MuJoCo Ant,
// Meta-World) is driven through per-env INDEXED callbacks. The C++ pool
// owns the batch fan-out; each callback re-enters Python (ctypes acquires
// the GIL) and the physics core (MuJoCo mj_step) releases the GIL again,
// so env steps genuinely overlap across threads.
// ---------------------------------------------------------------------------

typedef void (*py_reset_fn)(int env_idx, const double* task, double* obs);
typedef void (*py_step_fn)(int env_idx, const double* action, double* obs,
                           double* reward, double* done, double* success);

struct PyEnvState {
  int32_t idx;
  py_reset_fn reset;
  py_step_fn step;
};

static void py_shim_reset(void* s, const double* task, double* obs) {
  auto* st = reinterpret_cast<PyEnvState*>(s);
  st->reset(st->idx, task, obs);
}

static void py_shim_step(void* s, const double* action, double* obs,
                         double* reward, double* done, double* success) {
  auto* st = reinterpret_cast<PyEnvState*>(s);
  st->step(st->idx, action, obs, reward, done, success);
}

// ---------------------------------------------------------------------------
// Synthetic benchmark env: each step costs `busy_us` microseconds of
// simulated physics entirely on the C side (no GIL involvement).
// mode 0 (sleep): the step BLOCKS without holding the core
// (nanosleep) — the shape of physics that waits on devices or releases
// the GIL into another core's compute; the pool's fan-out should scale
// steps/sec ~linearly in n_threads even on a 1-core host, proving the
// batch path serializes nothing. mode 1 (spin): the step burns the core
// (steady_clock spin) — on a k-core host this scales to ~k, on a 1-core
// host it is flat by physics, which the bench records honestly.
// ---------------------------------------------------------------------------

struct BusyState {
  double pos;
  double busy_us;
  int32_t spin;
};

static void busy_reset(void* s, const double* task, double* obs) {
  auto* st = reinterpret_cast<BusyState*>(s);
  st->pos = task[0];
  obs[0] = st->pos;
  obs[1] = 0.0;
}

static void busy_step(void* s, const double* action, double* obs,
                      double* reward, double* done, double* success) {
  auto* st = reinterpret_cast<BusyState*>(s);
  if (st->spin) {
    auto until = std::chrono::steady_clock::now() +
                 std::chrono::nanoseconds((int64_t)(st->busy_us * 1000.0));
    while (std::chrono::steady_clock::now() < until) {
    }
  } else if (st->busy_us > 0.0) {
    struct timespec ts;
    ts.tv_sec = (time_t)(st->busy_us / 1e6);
    ts.tv_nsec = (long)((st->busy_us - ts.tv_sec * 1e6) * 1000.0);
    nanosleep(&ts, nullptr);
  }
  st->pos += action[0];
  obs[0] = st->pos;
  obs[1] = action[1];
  *reward = -st->pos * st->pos;
  *done = 0.0;
  *success = 0.0;
}

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

void* vecenv_create_particles2d(int n_envs, int n_threads) {
  EnvVTable vt{p2d_reset, p2d_step, 2, 2, sizeof(P2DState)};
  return new VecEnv(vt, n_envs, n_threads);
}

void* vecenv_create_busy(int n_envs, int n_threads, double busy_us,
                         int spin) {
  EnvVTable vt{busy_reset, busy_step, 2, 2, sizeof(BusyState)};
  auto* ve = new VecEnv(vt, n_envs, n_threads);
  for (int i = 0; i < n_envs; ++i) {
    auto* st = reinterpret_cast<BusyState*>(ve->states[i].data());
    st->busy_us = busy_us;
    st->spin = spin;
  }
  return ve;
}

void* vecenv_create_python(py_reset_fn reset, py_step_fn step, int obs_size,
                           int action_size, int n_envs, int n_threads) {
  EnvVTable vt{py_shim_reset, py_shim_step, obs_size, action_size,
               static_cast<int>(sizeof(PyEnvState))};
  auto* ve = new VecEnv(vt, n_envs, n_threads);
  for (int i = 0; i < n_envs; ++i) {
    auto* st = reinterpret_cast<PyEnvState*>(ve->states[i].data());
    st->idx = i;
    st->reset = reset;
    st->step = step;
  }
  return ve;
}

void vecenv_destroy(void* h) { delete reinterpret_cast<VecEnv*>(h); }

int vecenv_obs_size(void* h) { return reinterpret_cast<VecEnv*>(h)->vt.obs_size; }
int vecenv_action_size(void* h) {
  return reinterpret_cast<VecEnv*>(h)->vt.action_size;
}

// tasks: [n_envs, task_dim] (broadcast row 0 if task_rows == 1)
void vecenv_reset(void* h, const double* tasks, int task_rows, int task_dim,
                  double* obs_out) {
  auto* ve = reinterpret_cast<VecEnv*>(h);
  ve->run_batch([=](int i) {
    const double* task = tasks + (task_rows == 1 ? 0 : (size_t)i * task_dim);
    ve->vt.reset(ve->states[i].data(), task,
                 obs_out + (size_t)i * ve->vt.obs_size);
  });
}

void vecenv_step(void* h, const double* actions, double* obs_out,
                 double* rewards_out, double* dones_out,
                 double* success_out) {
  auto* ve = reinterpret_cast<VecEnv*>(h);
  ve->run_batch([=](int i) {
    ve->vt.step(ve->states[i].data(),
                actions + (size_t)i * ve->vt.action_size,
                obs_out + (size_t)i * ve->vt.obs_size,
                rewards_out + i, dones_out + i, success_out + i);
  });
}

}  // extern "C"
